"""SwapAlign2Nat (TensorMask, Chen et al. 2019) as 16 gathers (port of
`imagdressing_tpu/ops/swap_align2nat.py`).

Given sliding-window mask logits in the ALIGNED representation (channels
enumerate a V x U window per spatial cell), swap the unit lengths of the
window and spatial axes by the integer ratio `lambda_val` and resample into
the NATURAL representation:

  in  (N, H, W, V*U)   with V == U == sqrt(C)
  out (N, ceil(H/l), ceil(W/l), (l*V)*(l*U))

Each output element quadrilinearly interpolates 16 input points over
(y, x, v, u); points outside the tensor contribute `pad_val` (default -6,
sigmoid(-6) ~ 0 = "no mask"), as the reference's CUDA op (detectron2's
TensorMask project, SwapAlign2Nat_cuda.cu). Channels-last, as the JAX op;
the reference is NCHW with the same per-element semantics.

Each term is one `index_select` over the flattened input, laid out in the
output's (H_out, W_out, V_out, U_out) order, so autograd's backward is an
`index_add_` per term (advanced indexing's backward would sort the indices
first).
"""

from __future__ import annotations

import math

import torch


def _floor_parts(o: torch.Tensor):
    f = torch.floor(o)
    return f.long(), f.long() + 1, o - f


def swap_align2nat(x: torch.Tensor, lambda_val: int = 1,
                   pad_val: float = -6.0) -> torch.Tensor:
    if lambda_val < 1:
        raise ValueError(f"swap_align2nat: lambda_val {lambda_val} < 1")
    n, h, w, c = x.shape
    v_in = math.isqrt(c)
    u_in = c // v_in if v_in else 0
    if v_in != u_in or v_in * u_in != c:
        raise ValueError(f"swap_align2nat: {c} channels is not a square")
    lam = float(lambda_val)
    v_out, u_out = lambda_val * v_in, lambda_val * u_in
    h_out = math.ceil(h / lam)
    w_out = math.ceil(w / lam)
    h_vout, h_uout = v_out / 2.0, u_out / 2.0
    dev = x.device

    # continuous source coordinates in fp32 (the CUDA op's index math)
    def ar(m):
        return torch.arange(m, device=dev, dtype=torch.float32)

    vv, uu, yy, xx = ar(v_out), ar(u_out), ar(h_out), ar(w_out)
    oy = yy[None, :] * lam + vv[:, None] - h_vout + 0.5  # (Vout, Hout)
    ox = xx[None, :] * lam + uu[:, None] - h_uout + 0.5  # (Uout, Wout)
    ov = (vv + 0.5) / lam - 0.5  # (Vout,)
    ou = (uu + 0.5) / lam - 0.5  # (Uout,)

    # each axis broadcast into the output's (Hout, Wout, Vout, Uout) order
    def at_y(t):
        return t.t()[:, None, :, None]

    def at_x(t):
        return t.t()[None, :, None, :]

    def at_v(t):
        return t[None, None, :, None]

    def at_u(t):
        return t[None, None, None, :]

    yf, yc, yw = (at_y(t) for t in _floor_parts(oy))
    xf, xc, xw = (at_x(t) for t in _floor_parts(ox))
    vf, vc, vw = (at_v(t) for t in _floor_parts(ov))
    uf, uc, uw = (at_u(t) for t in _floor_parts(ou))

    flat = x.reshape(n, h * w * c)
    shape = (n, h_out, w_out, v_out, u_out)

    def term(yi, ywt, xi, xwt, vi, vwt, ui, uwt):
        valid = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
                 & (vi >= 0) & (vi < v_in) & (ui >= 0) & (ui < u_in))
        idx = (((yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)) * v_in
                + vi.clamp(0, v_in - 1)) * u_in + ui.clamp(0, u_in - 1))
        idx = idx.expand(shape[1:])
        g = flat.index_select(1, idx.reshape(-1)).reshape(shape)
        g = torch.where(valid.expand(shape[1:]), g,
                        torch.tensor(pad_val, dtype=g.dtype, device=dev))
        wgt = ywt * xwt * vwt * uwt
        return g * wgt.to(g.dtype)

    out = None
    for yi, ywt in ((yf, 1.0 - yw), (yc, yw)):
        for xi, xwt in ((xf, 1.0 - xw), (xc, xw)):
            for vi, vwt in ((vf, 1.0 - vw), (vc, vw)):
                for ui, uwt in ((uf, 1.0 - uw), (uc, uw)):
                    t = term(yi, ywt, xi, xwt, vi, vwt, ui, uwt)
                    out = t if out is None else out + t
    return out.reshape(n, h_out, w_out, v_out * u_out)
