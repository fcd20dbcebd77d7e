"""Flash attention over one or two KV sources, forward and backward:

    out = SDPA(q, k, v) + ref_scale[b] * SDPA(q, k_ref, v_ref)

Port of `imagdressing_tpu/kernels/flash_attention.py`. Four TPU kernels
become two CUDA sources:

  * K1 `_flash_kernel` (inference forward) -> `csrc/flash_fwd.cu`: one online
    softmax per source in fp32, the reference pass skipped for batch rows
    whose scale is 0 (the CFG uncond half), and a single-source mode; in
    bf16 a wgmma kernel fed by a TMA ring (one producer warp, two consumer
    warpgroups), whose tiles and ring depth come from `flash_plan`
    (at D = 512 two blocks of 256 output columns per q tile);
  * K5 `_flash_res_kernel` (training forward) -> the residual mode of the
    same kernels: also each source's base-2 log-sum-exp and the reference
    source's output O2, and no row is ever skipped;
  * K6a `_bwd_dkv_kernel` and K6b `_bwd_dq_kernel` -> `csrc/flash_bwd.cu`:
    wgmma kernels for dK/dV per key tile and dQ per query tile, probabilities
    recomputed from the saved log-sum-exp; K6b runs first and also writes
    the delta term D_i (from the stored O and O2) once per row, which K6a
    reads.

The kernels read q/k/v in their (B, S, H, D) layout by strides, so the JAX
wrapper's fold to (BH, S, D) and its concatenated KV axis are not needed.

Softmax scale: the kernels multiply the fp32 scores by log2(e)/sqrt(D) held
in fp32 and take exp2, so the scale is never rounded to bf16 (the TPU
kernels fold it into bf16 q instead; PARITY.md). The plain versions do the
same.

`flash_attention` is differentiable. When grad mode is on and any operand
requires a gradient, it runs `FlashAttentionFunction` (K5 forward, K6b/K6a
backward); otherwise K1. The Function's forward calls K5 through one
dispatcher op (`flash_fwd_res_op`), which a selective-checkpoint policy
can save by name. A CUDA tensor launches the kernels or raises; a CPU
tensor runs the plain versions (`flash_attention_plain`,
`flash_attention_res_plain`, `flash_attention_bwd_plain`), which repeat the
kernels' arithmetic and roundings.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Tuple, Union

import torch
from torch.autograd.function import once_differentiable

from imagdressing_tpu_torch.kernels import _build

COUNTER = _build.LaunchCounter()      # K1, inference forward
RES_COUNTER = _build.LaunchCounter()  # K5, training forward
DKV_COUNTER = _build.LaunchCounter()  # K6a
DQ_COUNTER = _build.LaunchCounter()   # K6b
_SOURCE = "flash_fwd.cu"
_BWD_SOURCE = "flash_bwd.cu"
LOG2E = 1.4426950408889634
MAX_HEAD_DIM = 512
MAX_GRAD_HEAD_DIM = 160
# the bf16 wgmma forward (`csrc/flash_fwd.cu:flash_fwd_wgmma`): its
# instantiated N widths of O += P V up to D = 160, the widths that also have
# 128-key tiles, the columns per block and the contraction above D = 160,
# the shared memory a block may use on the H100, the deepest ring
FWD_WIDTHS = (16, 32, 40, 64, 80, 128, 160)
FWD_BKV128_MAX_DN = 80
WIDE_DN, WIDE_DK = 256, 512
SMEM_LIMIT = 232448
MAX_STAGES = 4

Scale = Union[float, torch.Tensor, None]


def _scale_vec(ref_scale: Scale, b: int, device) -> torch.Tensor:
    s = torch.as_tensor(1.0 if ref_scale is None else ref_scale,
                        dtype=torch.float32, device=device)
    return s.reshape(-1).expand(b).contiguous()


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One source: (normalized fp32 output (B, Sq, H, D), base-2 lse
    (B, H, Sq)). fp32 scores, exp2 with the fp32 scale, probabilities rounded
    to the input dtype before the product with V."""
    scale_log2 = LOG2E / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale_log2
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(), v.float())
    return o / l.permute(0, 2, 1, 3), (m + torch.log2(l)).squeeze(-1)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          k_ref: Optional[torch.Tensor] = None,
                          v_ref: Optional[torch.Tensor] = None,
                          ref_scale: Scale = None) -> torch.Tensor:
    """K1's function in plain PyTorch: fp32 combine of the two sources, the
    reference pass left out where the scale is 0."""
    out, _ = _sdpa_plain(q, k, v)
    if k_ref is not None:
        s = _scale_vec(ref_scale, q.shape[0], q.device).reshape(-1, 1, 1, 1)
        out = torch.where(s == 0, out, out + s * _sdpa_plain(q, k_ref,
                                                             v_ref)[0])
    return out.to(q.dtype)


def flash_attention_res_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              k_ref: Optional[torch.Tensor] = None,
                              v_ref: Optional[torch.Tensor] = None,
                              ref_scale: Scale = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         Optional[torch.Tensor]]:
    """K5's function: (out, lse (B, H, n_sources, Sq) fp32 base 2, o2 (B, Sq,
    H, D) in the input dtype or None). Every source runs for every row."""
    o1, l1 = _sdpa_plain(q, k, v)
    if k_ref is None:
        return o1.to(q.dtype), l1[:, :, None], None
    o2, l2 = _sdpa_plain(q, k_ref, v_ref)
    s = _scale_vec(ref_scale, q.shape[0], q.device).reshape(-1, 1, 1, 1)
    return ((o1 + s * o2).to(q.dtype), torch.stack([l1, l2], dim=2),
            o2.to(q.dtype))


def flash_attention_delta_plain(g: torch.Tensor, out: torch.Tensor,
                                o2: Optional[torch.Tensor],
                                ref_scale: Optional[torch.Tensor]
                                ) -> torch.Tensor:
    """The D_i that K6b writes for K6a (`_bwd_di`): (B, H, n_sources, Sq)
    fp32, from the stored out and o2, never from an exact O1. One source:
    rowsum(g * out); two: rowsum(g * (out - s * o2)) and s * rowsum(g * o2).
    """
    g32, o32 = g.float(), out.float()

    def rowsum(x):  # (B, Sq, H, D) -> (B, H, Sq)
        return x.sum(-1).permute(0, 2, 1)

    if o2 is None:
        return rowsum(g32 * o32)[:, :, None]
    s = ref_scale.float()
    o2_32 = o2.float()
    return torch.stack([rowsum(g32 * (o32 - s.reshape(-1, 1, 1, 1) * o2_32)),
                        s.reshape(-1, 1, 1) * rowsum(g32 * o2_32)], dim=2)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, k_ref: Optional[torch.Tensor],
                              v_ref: Optional[torch.Tensor],
                              ref_scale: Optional[torch.Tensor],
                              out: torch.Tensor, lse: torch.Tensor,
                              o2: Optional[torch.Tensor], g: torch.Tensor):
    """K6a + K6b's function: (dq, dk, dv, dk_ref, dv_ref), the reference pair
    None with one source. The upstream gradient of the reference source is
    s*g rounded to the input dtype; D_i comes from the stored out and o2
    (`flash_attention_delta_plain`); p and dS are rounded to the input dtype
    before their products. A scale-0 row's reference gradients are exactly
    zero."""
    dt = q.dtype
    sl = LOG2E / math.sqrt(q.shape[-1])
    sm = 1.0 / math.sqrt(q.shape[-1])
    qf, g32 = q.float(), g.float()
    delta = flash_attention_delta_plain(g, out, o2, ref_scale)

    def source(k_, v_, i, coeff):
        g_e = (g32 * coeff.reshape(-1, 1, 1, 1)).to(dt).float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_.float()) * sl
        p = torch.exp2(s - lse[:, :, i, :, None])
        dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), g_e)
        dp = torch.einsum("bqhd,bkhd->bhqk", g_e, v_.float())
        ds = (p * (dp - delta[:, :, i, :, None])).to(dt).float()
        dq = sm * torch.einsum("bhqk,bkhd->bqhd", ds, k_.float())
        dk = sm * torch.einsum("bhqk,bqhd->bkhd", ds, qf)
        return dq, dk, dv

    one = torch.ones(q.shape[0], device=q.device)
    dq, dk, dv = source(k, v, 0, one)
    if k_ref is None:
        return dq.to(dt), dk.to(dt), dv.to(dt), None, None
    dq2, dkr, dvr = source(k_ref, v_ref, 1, ref_scale.float())
    return ((dq + dq2).to(dt), dk.to(dt), dv.to(dt), dkr.to(dt), dvr.to(dt))


# ---------------------------------------------------------------------------
# The bf16 forward's tiles
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """Tiles of the bf16 wgmma forward (K1, K5): `rows` q rows per block (64
    per consumer warpgroup), `bkv` keys per tile, a ring of `stages` key /
    value stages; `dn` the output columns of a block, the N width of O += P
    V (up to D = 160 the smallest instantiated width >= D, one block per q
    tile; above, WIDE_DN with ceil(D / dn) blocks per q tile), `dk` the
    contraction (D padded to 16; WIDE_DK above D = 160), `smem` the block's
    shared memory in bytes, `blocks` the launch's blocks."""
    rows: int
    bkv: int
    stages: int
    dn: int
    dk: int
    smem: int
    blocks: int


def fwd_smem(rows: int, bkv: int, stages: int, dn: int, dk: int,
             dual: bool) -> int:
    """`csrc/flash_fwd.cu:fwd_smem`: the q tile, the ring of key (dk
    columns) and value (dn columns) tiles, source 0's fp32 output where it
    does not stay in registers (two sources, dn > 128), the mbarriers."""
    return (2 * (rows * dk + stages * bkv * (dk + dn))
            + (rows * dn * 4 if dual and dn > 128 else 0)
            + (2 * stages + 1) * 8)


def fwd_tiles(d: int) -> Tuple[Tuple[int, int], ...]:
    """The (rows, keys per tile) the bf16 forward is built with at head dim
    d (`csrc/flash_fwd.cu:by_width`)."""
    if d > MAX_GRAD_HEAD_DIM:
        return ((64, 32),)
    dn = min(w for w in FWD_WIDTHS if w >= d)
    bkvs = (64, 128) if dn <= FWD_BKV128_MAX_DN else (64,)
    return tuple((rows, bkv) for rows in (128, 64) for bkv in bkvs)


@functools.lru_cache(maxsize=None)
def flash_plan(b: int, sq: int, h: int, d: int, dual: bool,
               rows: Optional[int] = None, bkv: Optional[int] = None,
               stages: Optional[int] = None) -> FlashPlan:
    """The bf16 forward's tiles for q (b, sq, h, d) with one or two sources,
    as measured on the H100 (`tools/time_flash_ops.py --sweep`, PERF.md).
    Rows: 128 (two consumer warpgroups share each key tile), even where that
    leaves fewer blocks than SMs, except above D = 128, where source 0's
    output waits in shared memory and 128-row blocks keep only a two-stage
    ring: there 64. Keys per tile: 128 up to D = 80 (the per-tile fixed cost
    over twice the keys), else 64 (registers); 32 above D = 160, whose
    blocks hold a 512-wide contraction. The ring: the deepest of MAX_STAGES
    .. 2 that fits the block's shared memory. `rows`, `bkv`, `stages` force
    a choice among `fwd_tiles(d)` (the timing tools compare plans). Cached
    per shape: the wrapper asks on every launch."""
    if d > MAX_GRAD_HEAD_DIM:
        dn, dk = WIDE_DN, WIDE_DK
    else:
        dn, dk = min(w for w in FWD_WIDTHS if w >= d), -(-d // 16) * 16
    if rows is None:
        rows = 64 if dn > 128 else 128
    if bkv is None:
        bkv = 32 if dn > MAX_GRAD_HEAD_DIM else (
            128 if dn <= FWD_BKV128_MAX_DN else 64)
    if stages is None:
        stages = next((n for n in range(MAX_STAGES, 1, -1)
                       if fwd_smem(rows, bkv, n, dn, dk, dual) <= SMEM_LIMIT),
                      2)
    return FlashPlan(rows, bkv, stages, dn, dk,
                     fwd_smem(rows, bkv, stages, dn, dk, dual),
                     b * h * -(-sq // rows) * -(-d // dn))


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its functions typed, once per process."""
    lib = _build.load(_SOURCE)
    for fn in (lib.flash_fwd_bf16_launch, lib.flash_fwd_f32_launch):
        fn.argtypes = [_P] * 7 + [_I] * 6 + [_P, _F, _P, _P]
        fn.restype = _I
    for fn in (lib.flash_fwd_res_bf16_launch, lib.flash_fwd_res_f32_launch):
        fn.argtypes = [_P] * 7 + [_I] * 6 + [_P, _F, _P, _P, _P, _P]
        fn.restype = _I
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load(_BWD_SOURCE)
    for fn in (lib.flash_bwd_dkv_bf16_launch, lib.flash_bwd_dq_bf16_launch,
               lib.flash_bwd_dkv_f32_launch, lib.flash_bwd_dq_f32_launch):
        fn.argtypes = [_P] * 6 + [_F, _F, _P]
        fn.restype = _I
    return lib


def _check_operand(name: str, t: torch.Tensor, b: int, h: int, d: int,
                   dtype: torch.dtype) -> None:
    if t.ndim != 4 or t.shape[0] != b or t.shape[2] != h or t.shape[3] != d:
        raise ValueError(f"flash_attention: {name} shape {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"flash_attention: {name} dtype {t.dtype} != {dtype}")
    if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]):
        raise ValueError(f"flash_attention: {name} strides {t.stride()}")


def _check_inputs(q, k, v, k_ref, v_ref, max_d: int) -> None:
    """Device, dtype, shape and stride checks of a CUDA launch."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention: dtype {q.dtype}")
    b, _, h, d = q.shape
    if d % 8 or d > max_d:
        raise ValueError(f"flash_attention: head dim {d} (at most {max_d} "
                         "here, a multiple of 8)")
    ops = [("q", q), ("k", k), ("v", v)]
    if k_ref is not None:
        ops += [("k_ref", k_ref), ("v_ref", v_ref)]
    for name, t in ops:
        _check_operand(name, t, b, h, d, q.dtype)
    if v.shape[1] != k.shape[1] or (k_ref is not None
                                    and v_ref.shape[1] != k_ref.shape[1]):
        raise ValueError("flash_attention: k and v lengths differ")
    if min(t.shape[1] for _, t in ops) == 0:
        raise ValueError("flash_attention: an empty sequence")


def _strides(*tensors) -> ctypes.Array:
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch_fwd(q, k, v, k_ref, v_ref, scale, residuals: bool,
                plan: Optional[FlashPlan] = None):
    """K1 (residuals=False) -> out; K5 (True) -> (out, lse, o2). `plan`
    replaces `flash_plan`'s choice for the bf16 kernel (timing tools)."""
    b, sq, h, d = q.shape
    dual = k_ref is not None
    out = torch.empty((b, sq, h, d), device=q.device, dtype=q.dtype)
    lse = o2 = None
    extra = []
    if residuals:
        lse = torch.empty((b, h, 2 if dual else 1, sq), device=q.device,
                          dtype=torch.float32)
        o2 = torch.empty_like(out) if dual else None
        extra = [lse] + ([o2] if dual else [])
    _build.check_operands("flash_attention", q, k, v,
                          *((k_ref, v_ref, scale) if dual else ()), out,
                          *extra)
    kr, vr = (k_ref, v_ref) if dual else (k, v)
    strided = [q, k, v, kr, vr, out] + ([o2 if dual else out]
                                        if residuals else [])
    strides = _strides(*strided)
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        plan = plan or flash_plan(b, sq, h, d, dual)
        tiles = (ctypes.c_int * 3)(plan.rows, plan.bkv, plan.stages)
    else:
        tiles = (ctypes.c_int * 3)(0, 0, 0)
    lib = _lib()
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_ref.data_ptr() if dual else None,
            v_ref.data_ptr() if dual else None,
            scale.data_ptr() if dual else None, out.data_ptr(),
            b, h, sq, k.shape[1], kr.shape[1], d,
            ctypes.cast(strides, ctypes.c_void_p), LOG2E / math.sqrt(d),
            ctypes.cast(tiles, ctypes.c_void_p),
            _build.stream_handle(q.device)]
    if residuals:
        fn = lib.flash_fwd_res_bf16_launch if bf16 \
            else lib.flash_fwd_res_f32_launch
        rc = fn(*args, lse.data_ptr(), o2.data_ptr() if dual else None)
        _build.check(rc, "flash_attention (K5)")
        RES_COUNTER.add((b, sq, h, d, dual))
        return out, lse, o2
    fn = lib.flash_fwd_bf16_launch if bf16 else lib.flash_fwd_f32_launch
    rc = fn(*args)
    _build.check(rc, "flash_attention")
    COUNTER.add((b, sq, h, d, dual))
    return out


def _launch_bwd(q, k, v, k_ref, v_ref, scale, out, lse, o2, g,
                parts=("dq", "dkv"), delta=None):
    """K6b then K6a -> ((dq, dk, dv, dk_ref, dv_ref), delta): K6b writes D_i
    (`delta`, (B, H, n_sources, Sq) fp32) and K6a reads it. `parts` names
    the kernels to launch (a timing run launches one alone; the gradients of
    a kernel left out are uninitialised, and K6a alone needs the `delta` of
    an earlier K6b launch on the same inputs)."""
    b, sq, h, d = q.shape
    dual = k_ref is not None
    _check_operand("g", g, b, h, d, q.dtype)
    stat_shape = (b, h, 2 if dual else 1, sq)
    if delta is None:
        if "dq" not in parts:
            raise ValueError("flash_attention backward: K6a alone needs the "
                             "delta of an earlier K6b launch")
        delta = torch.empty(stat_shape, device=q.device, dtype=torch.float32)
    elif (tuple(delta.shape) != stat_shape or delta.dtype != torch.float32
          or not delta.is_contiguous()):
        raise ValueError(f"flash_attention backward: delta {delta.shape} "
                         f"{delta.dtype}, want {stat_shape} float32")
    grads = [torch.empty_like(t) for t in (q, k, v)]
    grads += [torch.empty_like(k_ref), torch.empty_like(v_ref)] if dual \
        else [None, None]
    ordered = [q, k, v, k_ref, v_ref, g, out, o2] + grads
    _build.check_operands("flash_attention backward",
                          *(t for t in ordered if t is not None), lse, delta,
                          *((scale,) if dual else ()))
    stand_in = [t if t is not None else q for t in ordered]
    strides = _strides(*stand_in)
    ptrs = (ctypes.c_void_p * 13)(*(t.data_ptr() if t is not None else None
                                    for t in ordered))
    dims = (ctypes.c_int * 7)(b, h, sq, k.shape[1],
                              k_ref.shape[1] if dual else 0, d,
                              2 if dual else 1)
    lib = _bwd_lib()
    bf16 = q.dtype == torch.bfloat16
    args = (ctypes.cast(ptrs, ctypes.c_void_p), lse.data_ptr(),
            scale.data_ptr() if dual else None, delta.data_ptr(),
            ctypes.cast(dims, ctypes.c_void_p),
            ctypes.cast(strides, ctypes.c_void_p), LOG2E / math.sqrt(d),
            1.0 / math.sqrt(d), _build.stream_handle(q.device))
    key = (b, sq, h, d, dual)
    if "dq" in parts:
        fn = lib.flash_bwd_dq_bf16_launch if bf16 \
            else lib.flash_bwd_dq_f32_launch
        _build.check(fn(*args), "flash_attention backward (K6b)")
        DQ_COUNTER.add(key)
    if "dkv" in parts:
        fn = lib.flash_bwd_dkv_bf16_launch if bf16 \
            else lib.flash_bwd_dkv_f32_launch
        _build.check(fn(*args), "flash_attention backward (K6a)")
        DKV_COUNTER.add(key)
    return tuple(grads), delta


# ---------------------------------------------------------------------------
# Differentiable entry
# ---------------------------------------------------------------------------


def flash_attention_res(q, k, v, k_ref, v_ref, scale):
    """K5 on a CUDA tensor, its plain version on a CPU tensor: (out, lse,
    o2). `scale` is the (B,) fp32 vector (None with one source)."""
    if q.device.type == "cpu":
        return flash_attention_res_plain(q, k, v, k_ref, v_ref, scale)
    _check_inputs(q, k, v, k_ref, v_ref, MAX_GRAD_HEAD_DIM)
    return _launch_fwd(q, k, v, k_ref, v_ref, scale, residuals=True)


def flash_attention_bwd(q, k, v, k_ref, v_ref, scale, out, lse, o2, g):
    """K6a + K6b on a CUDA tensor, their plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, k_ref, v_ref, scale, out,
                                         lse, o2, g)
    _check_inputs(q, k, v, k_ref, v_ref, MAX_GRAD_HEAD_DIM)
    return _launch_bwd(q, k, v, k_ref, v_ref, scale, out, lse, o2, g)[0]


@torch.library.custom_op("imagdressing_tpu_torch::flash_fwd_res",
                         mutates_args=())
def flash_fwd_res_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     k_ref: Optional[torch.Tensor],
                     v_ref: Optional[torch.Tensor],
                     scale: Optional[torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`flash_attention_res` as one dispatcher op (o2 empty with one
    source). The ctypes launch inside is invisible to PyTorch's dispatcher;
    as an op, a selective-checkpoint policy can save its outputs by name
    (`models.unet`'s "names" and "heavy" remat), so the backward's recompute
    returns them instead of launching K5 again."""
    out, lse, o2 = flash_attention_res(q, k, v, k_ref, v_ref, scale)
    return out, lse, out.new_empty(0) if o2 is None else o2


class FlashAttentionFunction(torch.autograd.Function):
    """The JAX package's `_fa_diff` custom VJP: the forward saves (q, k, v,
    k_ref, v_ref, scale, out, lse, o2); the backward runs K6a and K6b, and
    d scale[b] = sum(g * O2) over row b (a torch reduction, as in JAX) when
    the scale requires a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, k_ref, v_ref, scale):
        out, lse, o2 = flash_fwd_res_op(q, k, v, k_ref, v_ref, scale)
        o2 = o2 if k_ref is not None else None
        ctx.save_for_backward(q, k, v, k_ref, v_ref, scale, out, lse, o2)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, k_ref, v_ref, scale, out, lse, o2 = ctx.saved_tensors
        g = g.contiguous()
        dq, dk, dv, dkr, dvr = flash_attention_bwd(q, k, v, k_ref, v_ref,
                                                   scale, out, lse, o2, g)
        dscale = None
        if ctx.needs_input_grad[5]:
            dscale = (g.float() * o2.float()).sum((1, 2, 3))
        return dq, dk, dv, dkr, dvr, dscale


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    k_ref: Optional[torch.Tensor] = None,
                    v_ref: Optional[torch.Tensor] = None,
                    ref_scale: Scale = None) -> torch.Tensor:
    """q (B, Sq, H, D); k/v (B, Skv, H, D); k_ref/v_ref (B, Sref, H, D) or
    None; ref_scale a scalar or (B,) (default 1). Returns (B, Sq, H, D)
    contiguous. Any sequence lengths (the ragged edge is masked); on the
    card D must be a multiple of 8, at most 512 without a gradient and at
    most 160 with one, and every stride but the last a multiple of 8."""
    if (k_ref is None) != (v_ref is None):
        raise ValueError("flash_attention: pass both k_ref and v_ref or neither")
    scale = _scale_vec(ref_scale, q.shape[0], q.device) \
        if k_ref is not None else None
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (q, k, v, k_ref, v_ref, scale)):
        return FlashAttentionFunction.apply(q, k, v, k_ref, v_ref, scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, k_ref, v_ref, ref_scale)
    _check_inputs(q, k, v, k_ref, v_ref, MAX_HEAD_DIM)
    return _launch_fwd(q, k, v, k_ref, v_ref, scale, residuals=False)
