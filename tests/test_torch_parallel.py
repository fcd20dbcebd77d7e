"""The port's multi-device layer on the CPU: two gloo ranks against one
process and against the JAX package's multi-device steps.

One 2-rank world (started by `parallel.launch.spawn`, as the apps start
theirs) runs, once for the whole module, every scenario of
`imagdressing_tpu_torch.tools.dist_check.rank_main` on the mini stack
(`dist_check.mini_models`, fp32): two ZeRO-2 steps, a split checkpoint and
a non-finite step; the tensor-parallel (model = 2) UNet forward and two TP
steps; `pose` over the data group on a ragged batch of 3, through the
server's broadcast rounds, and `basic` over the model group; the parser's
synced fine-tune step (SCHP at full width, 64x64). Then, in the same two
processes, `train_cli` and `dress` with `--data_parallel 2
--allow_cpu_mesh` (the loader stubbed with the small random stack and the
tokenizer with one inside its 256 ids, as `test_torch_train_cli.py` and
`test_torch_apps.py` stub them), each joining a world of its own.
`dist_check.single` and the one-process `dress` run alongside, in this
process.

The JAX side is `tests/goldens/torch_parallel_tiny.npz`: the JAX package's
`shard_train_step` (data = 2) and `tp_train_step` (model = 2) on 2 CPU
devices, and its `shard_parsing_train_step` (data = 2), from the port's
weights (the mini stack and `schp.init(0)` converted to JAX trees), with
the draws JAX's keys give (which the port's steps then take as data).
Re-record it (JAX on the CPU, a few minutes of compile):

    JAX_PLATFORMS=cpu python tests/test_torch_parallel.py

`test_parallel_golden_is_current` (slow) recomputes it live.
"""

import dataclasses
import functools
import os
import threading

import json

import numpy as np
import pytest
import torch
from PIL import Image

import imagdressing_tpu_torch.apps.dress as dress
import imagdressing_tpu_torch.apps.loader as loader_mod
import imagdressing_tpu_torch.apps.tokenizer as tok_mod
import imagdressing_tpu_torch.apps.train_cli as train_cli
from imagdressing_tpu_torch.apps import image_utils as iu
from imagdressing_tpu_torch.apps.tokenizer import HashTokenizer
from imagdressing_tpu_torch.convert import train_state_from_jax
from imagdressing_tpu_torch.core import mesh as mesh_lib
from imagdressing_tpu_torch.core import tp as tp_lib
from imagdressing_tpu_torch.parallel import launch
from imagdressing_tpu_torch.pipelines.dressing import DressingModels
from imagdressing_tpu_torch.tools import dist_check as dc
from imagdressing_tpu_torch.train import checkpoint as ck
from imagdressing_tpu_torch.train import step as tstep

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "torch_parallel_tiny.npz")
# JAX tree paths of the trainables the golden keeps after two steps: the
# garment UNet's convs and norms, the split projections (to_q, to_v, to_out,
# the GEGLU and down projections), the adapters and the Resampler
TRAIN_LEAVES = (
    "ref_unet/conv_in/kernel",
    "ref_unet/down_blocks/0/resnets/0/conv1/kernel",
    "ref_unet/down_blocks/0/attentions/0/norm/scale",
    "ref_unet/down_blocks/1/attentions/0/transformer_blocks/0/attn1/to_q/kernel",
    "ref_unet/down_blocks/1/attentions/0/transformer_blocks/0/attn1/to_out/kernel",
    "ref_unet/down_blocks/1/attentions/0/transformer_blocks/0/ff/proj/kernel",
    "ref_unet/down_blocks/1/attentions/0/transformer_blocks/0/ff/proj/bias",
    "ref_unet/down_blocks/1/attentions/0/transformer_blocks/0/ff/out/kernel",
    "ref_unet/mid_block/attentions/0/transformer_blocks/0/attn1/to_k/kernel",
    "ref_unet/up_blocks/1/attentions/2/transformer_blocks/0/attn1/to_v/kernel",
    "ref_adapters/down_blocks.0.attentions.0.transformer_blocks.0.attn1"
    ".processor/to_k_ref/kernel",
    "resampler/latents",
    "resampler/proj_in/kernel",
)


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


def _jax_draws(golden):
    return [{f.name: golden[f"draws{i}/{f.name}"]
             for f in dataclasses.fields(tstep.Draws)} for i in range(2)]


SIZE = 64
DRESS = ["--height", str(SIZE), "--width", str(SIZE),
         "--num_inference_steps", "2", "--seed", "3"]


def _stub(monkeypatch) -> None:
    """The loader gives the small random stack on the asked device; the
    tokenizer stays inside its 256 ids."""
    monkeypatch.setattr(
        loader_mod, "load_dressing_models",
        lambda **kw: DressingModels.init_random(0, small=True,
                                                device=kw["device"]))
    monkeypatch.setattr(tok_mod, "load_tokenizer",
                        lambda path, max_length=77: HashTokenizer(256))


def _rank(spec, train_argv, dress_argv, ports):
    """One rank: dist_check's scenarios, then the train CLI and the dress
    CLI, each in a world of its own (a fresh port)."""
    out = dc.rank_main(spec)
    mp = pytest.MonkeyPatch()
    try:
        _stub(mp)
        os.environ["MASTER_PORT"] = str(ports[0])
        train_cli.main(train_argv)
        os.environ["MASTER_PORT"] = str(ports[1])
        dress.main(dress_argv)
    finally:
        mp.undo()
    return out


def _manifest(root, n=2):
    rng = np.random.default_rng(0)
    items = []
    for i in range(n):
        for kind in ("person", "cloth"):
            Image.fromarray(rng.integers(0, 255, (96, 80, 3), dtype=np.uint8)
                            ).save(root / f"{kind}{i}.jpg")
        items.append({"image_file": f"person{i}.jpg",
                      "cloth_file": f"cloth{i}.jpg",
                      "text": ["a red dress", "red summer dress"]})
    path = root / "manifest.json"
    path.write_text(json.dumps(items))
    return path


def _garments(root, n=3):
    root.mkdir()
    for i in range(n):
        img = np.random.default_rng(i).integers(0, 255, (90, 70, 3),
                                                dtype=np.uint8)
        Image.fromarray(img).save(root / f"g{i}.png")


@pytest.fixture(scope="module")
def runs(golden, tmp_path_factory):
    """The 2-rank world and, beside it, the one-process runs. -> (rank 0's
    dist_check results, rank 1's, the one-process results, paths: the
    ZeRO-2 checkpoint dir, the train CLI's argv and run dir, the dress
    CLI's argv, its 2-rank and its one-process output dirs)."""
    root = tmp_path_factory.mktemp("parallel")
    manifest = _manifest(root)
    _garments(root / "garments")
    spec = dc.make_spec("cpu", draws=_jax_draws(golden),
                        ckpt_dir=str(root / "ckpt"))
    train_argv = ["--data_json_file", str(manifest), "--data_root_path",
                  str(root), "--output_dir", str(root / "run"),
                  "--crop_height", str(SIZE), "--crop_width", str(SIZE),
                  "--resize_shorter", str(SIZE), "--num_train_steps", "2",
                  "--checkpointing_steps", "2", "--logging_steps", "1",
                  "--lr_warmup_steps", "1", "--learning_rate", "1e-3",
                  "--train_batch_size", "1", "--dataloader_num_workers", "1"]
    dress_argv = ["--cloth_dir", str(root / "garments")] + DRESS
    mesh = ["--data_parallel", "2", "--allow_cpu_mesh", "--device", "cpu"]
    paths = {"ckpt": spec["ckpt_dir"], "train_argv": train_argv,
             "run": root / "run", "dress_argv": dress_argv,
             "dress2": root / "out2", "dress1": root / "out1"}
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    one = {}

    def beside():
        # the parser's one-process step is held on the card (chip_smoke's
        # dist_check); here its ranks are held against JAX's
        one.update(dc.single(dict(spec, parts=("train", "generate"))))
        mp = pytest.MonkeyPatch()
        try:
            _stub(mp)
            dress.main(dress_argv + ["--output_path", str(paths["dress1"]),
                                     "--batch_size", "2", "--device", "cpu"])
        finally:
            mp.undo()
        one["done"] = True

    side = threading.Thread(target=beside)
    side.start()
    try:
        ranks = launch.spawn(
            _rank, 2, (spec, train_argv + mesh,
                       dress_argv + ["--output_path", str(paths["dress2"])]
                       + mesh, (launch.free_port(), launch.free_port())),
            timeout=300, threads=2)
    finally:
        side.join()
        torch.set_num_threads(n)
    assert one.get("done"), "the one-process runs failed"
    return ranks[0], ranks[1], one, paths


@functools.lru_cache(maxsize=1)
def _layout():
    """(model, port name, shape) of the mini stack's trainables in the
    flat host order."""
    models = dc.mini_models()
    return tuple((k, n, tuple(t.shape)) for k in tstep.TRAINABLE_KEYS
                 for n, t in getattr(models, k).state_dict().items())


def _leaf(flat: np.ndarray, jax_path: str) -> np.ndarray:
    """A JAX-path leaf of a flat host vector, in the JAX layout."""
    from imagdressing_tpu_torch.convert import _convert_leaf
    from imagdressing_tpu_torch.models.unet import adapter_key

    model, rest = jax_path.split("/", 1)
    parts = rest.split("/")
    if model == "ref_adapters":
        parts[0] = adapter_key(parts[0])
    name = _convert_leaf(tuple(parts), np.zeros((1, 1)))[0]
    at = 0
    for k, n, shape in _layout():
        size = int(np.prod(shape))
        if (k, n) == (model, name):
            t = torch.from_numpy(flat[at:at + size].reshape(shape))
            if rest.endswith("kernel"):
                t = t.t() if t.ndim == 2 else t.permute(2, 3, 1, 0)
            return t.numpy()
        at += size
    raise KeyError(jax_path)


def _close(got, want, atol, rtol, what):
    tol = atol + rtol * float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= tol, f"{what}: max err {err:.3g} > {tol:.3g}"


@pytest.mark.parametrize("kind", ["zero2", "tp"])
def test_train_steps_match_one_process_and_jax(runs, golden, kind):
    """Two ZeRO-2 (data = 2) or TP (model = 2) steps from the same weights
    and draws: against the port's one-process step on the global batch,
    the losses within rtol 1e-6, the grad norms 2e-6, every trainable, mu
    and nu within 1e-5 (the AdamW step is ~1e-3 per element; the sums'
    order differs), and both ranks equal; against JAX's `shard_train_step`
    / `tp_train_step` on 2 CPU devices, the losses and grad norms within
    rtol 1e-4 and TRAIN_LEAVES within atol 2e-6 + rtol 1e-4 * max|JAX|
    (`test_train_steps_match_jax_golden`'s bounds)."""
    r0, r1, one, _ = runs
    got, ref = r0[kind], one["train"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-6)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=2e-6)
    for k in ("params", "mu", "nu"):
        _close(got[k], ref[k], 1e-5, 0.0, f"{kind} {k} vs one process")
        np.testing.assert_array_equal(got[k], r1[kind][k])
    jkind = "shard" if kind == "zero2" else "tp"
    for i in (1, 2):
        np.testing.assert_allclose(got["loss"][i - 1],
                                   golden[f"{jkind}/step{i}/loss"], rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"][i - 1],
                                   golden[f"{jkind}/step{i}/grad_norm"],
                                   rtol=1e-4)
    for leaf in TRAIN_LEAVES:
        _close(_leaf(got["params"], leaf), golden[f"{jkind}/step2/{leaf}"],
               2e-6, 1e-4, f"{kind} {leaf} vs JAX")


def test_zero2_splits_the_optimizer_state(runs):
    """Each data rank holds half of the flat moments (padded), TP's local
    moments are the replicated leaves and half of the split ones."""
    r0, r1, _, _ = runs
    n = r0["zero2"]["mu"].size
    assert r0["zero2"]["local_moments"] == r1["zero2"]["local_moments"] \
        == -(-n // 2)
    models = dc.mini_models()
    split = sum(t.numel() for k in ("ref_unet", "ref_adapters")
                for name, t in getattr(models, k).state_dict().items()
                if tp_lib.tp_kind(name))
    assert split > n // 4
    assert r0["tp"]["local_moments"] == n - split // 2


def test_zero2_nonfinite_step_is_a_global_noop(runs):
    """A NaN in data rank 0's rows: the global norm is not finite, and on
    both ranks the trainables, mu, nu and the count stay as they were."""
    for r in runs[:2]:
        z = r["zero2"]
        assert not np.isfinite(z["nonfinite_grad_norm"])
        assert z["nonfinite_params_kept"] and z["nonfinite_opt_kept"]


def test_tp_forward_matches_unsplit(runs):
    """The main UNet split over 2 ranks (4 heads -> 2 each, the garment K/V
    from the split adapters, the text K/V precomputed) against the unsplit
    one: within 2e-5 (the partial sums' order), both ranks equal."""
    r0, r1, one, _ = runs
    _close(r0["tp_forward"], one["tp_forward"], 2e-5, 0.0, "TP forward")
    np.testing.assert_array_equal(r0["tp_forward"], r1["tp_forward"])


def test_data_parallel_pose_of_a_ragged_batch_matches_single_runs(runs):
    """`pose` over 2 data ranks on 3 rows (padded to 4, sliced back), each
    rank holding all 3 images, against each row alone: within 1e-5; the
    first two rows through the server's broadcast rounds (a row a rank)
    too."""
    r0, r1, one, _ = runs
    assert r0["pose"].shape == (3, 64, 64, 3)
    _close(r0["pose"], one["pose"], 1e-5, 0.0, "pose over 2 ranks")
    np.testing.assert_array_equal(r0["pose"], r1["pose"])
    assert r1["serve"] is None
    _close(r0["serve"], one["pose"][:2], 1e-5, 0.0, "served rounds")


def test_eta_noise_streams_differ_by_data_rank():
    """Each data rank draws its DDIM eta noise from its own stream (the JAX
    package folds the rank into its key); data rank 0's is one process's
    (SeedSequence drops the trailing zero word)."""
    from imagdressing_tpu_torch.pipelines.dressing import eta_seed

    assert len({eta_seed(42, 0), eta_seed(42, 1), eta_seed(43, 0)}) == 3
    assert eta_seed(42, 0) == eta_seed(42)


def test_tensor_parallel_basic_matches_unsplit(runs):
    """`basic` with the UNets split over 2 ranks against the unsplit run:
    within 1e-5."""
    r0, r1, one, _ = runs
    _close(r0["basic_tp"], one["basic"], 1e-5, 0.0, "basic over 2 ranks")
    np.testing.assert_array_equal(r0["basic_tp"], r1["basic_tp"])


def test_parser_step_matches_jax(runs, golden):
    """The parser's step over 2 data ranks (BN statistics and the CE
    normalisation synced, gradients averaged) against JAX's
    `shard_parsing_train_step` on 2 CPU devices (the one-process step:
    `chip_smoke.py` dist_check). The random-init net in train mode
    amplifies rounding (`test_two_train_steps_match_jax`), and the synced
    statistics add a sum order: the loss within rtol 1e-5 (measured
    4.0e-6; against one process 1.1e-6), each leaf's update within 0.15 of
    it in L2 (measured at most 3.5 % against one process), the running
    statistics within 3e-3; both ranks equal."""
    r0, r1, _, _ = runs
    got, want = r0["parser"], _jax_parser(golden)
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    for k in dc.PARSER_LEAVES:
        a, b = got[f"update/{k}"], want[f"update/{k}"]
        assert np.linalg.norm(a - b) <= 0.15 * np.linalg.norm(b), k
    for k in dc.PARSER_STATS:
        _close(got[f"stat/{k}"], want[f"stat/{k}"], 3e-3, 0.0, k)
    for k, v in got.items():
        np.testing.assert_array_equal(v, r1["parser"][k], err_msg=k)


def _jax_parser(golden):
    """The golden's parser results (stored with the port's names and
    layouts), the ABNs' affine updates taken back to one device's: JAX's
    `shard_parsing_train_step` psums their gradients in the ABN's VJP and
    then pmeans them, which leaves the data group's size (2) times the
    single-device gradient (ROADMAP Queue 3), so with SGD's first step
    u = -lr * (g + wd * p), one device's update is (u_jax - lr * wd * p) / 2
    (p before the step)."""
    from imagdressing_tpu_torch.train.parsing_train import lr_schedule

    out = {"loss": float(golden["parser/loss"])}
    out.update({k[len("parser/"):]: v for k, v in golden.items()
                if k.startswith(("parser/update/", "parser/stat/"))})
    cfg = dc.parser_config()
    lr_wd = lr_schedule(cfg)(0) * cfg.weight_decay
    before = dc.parser_net("cpu").state_dict()
    for k in dc.PARSER_LEAVES:
        if k.split(".")[-2].startswith("bn"):
            p = before[k].detach().numpy()
            out[f"update/{k}"] = (out[f"update/{k}"] - lr_wd * p) / 2
    return out


def test_world2_checkpoint_resumes_at_world1_and_serves(runs, tmp_path):
    """The checkpoint the 2 ZeRO-2 ranks saved (rank 0 wrote it) holds the
    whole state: it loads into a one-process trainer (the trainables and
    moments equal to the ranks' gathered ones) and into a stack through
    `merge_trained_checkpoint`."""
    from imagdressing_tpu_torch.apps.loader import merge_trained_checkpoint
    from imagdressing_tpu_torch.train.checkpoint import (
        CheckpointManager,
        saved_steps,
    )

    r0, _, _, paths = runs
    ckpt = paths["ckpt"]
    assert saved_steps(ckpt) == [2]
    models = dc.mini_models()
    state, _, _ = tstep.init_train_state(models, dc.train_config())
    restored, extra = CheckpointManager(ckpt).restore(state)
    assert restored.step == 2 and extra == {"step": 2}
    flat = dc._flat_host(restored)
    for k in ("params", "mu", "nu"):
        np.testing.assert_array_equal(flat[k], r0["zero2"][k])
    stack = merge_trained_checkpoint(dc.mini_models(), ckpt)
    want = torch.from_numpy(r0["zero2"]["params"][:stack.ref_unet.conv_in
                                                  .weight.numel()])
    assert torch.equal(stack.ref_unet.conv_in.weight.reshape(-1), want)


def test_tp_rules_and_round_trips():
    """`_spec_for_path`'s rules on the port's names; each split kind's
    slices reassemble the parameter; GEGLU's halves split each by rank."""
    rules = {
        "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q.weight":
            "column",
        "mid_block.attentions.0.transformer_blocks.0.attn2.to_v.weight":
            "column",
        "up_blocks.1.attentions.2.transformer_blocks.0.attn1.to_out.weight":
            "row",
        "up_blocks.1.attentions.2.transformer_blocks.0.attn1.to_out.bias":
            None,
        "down_blocks.0.attentions.0.transformer_blocks.0.ff.proj.weight":
            "geglu",
        "down_blocks.0.attentions.0.transformer_blocks.0.ff.proj.bias":
            "geglu",
        "down_blocks.0.attentions.0.transformer_blocks.0.ff.out.weight":
            "row",
        "down_blocks.0.attentions.0.proj_in.weight": None,
        "down_blocks.0.resnets.0.conv1.weight": None,
        "down_blocks_0_attentions_0_transformer_blocks_0_attn1_processor"
        ".to_k_ref.weight": "column",
    }
    for name, kind in rules.items():
        assert tp_lib.tp_kind(name) == kind, name
    full = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    for kind in ("column", "row", "geglu"):
        parts = [tp_lib.shard_tensor(kind, full, r, 2) for r in range(2)]
        assert torch.equal(tp_lib.unshard_tensor(kind, parts), full)
    h0, g0 = tp_lib.shard_tensor("geglu", full, 0, 2).chunk(2)
    assert torch.equal(h0, full[:2]) and torch.equal(g0, full[4:6])


def test_train_state_from_jax_loads_each_rank_part():
    """A JAX-layout state (trainables and AdamW moments as trees, as
    `shard_train_step`'s sharded state gathers to the host) loads into a
    one-process state and into each part of a ZeRO-2 and a TP layout:
    the parts reassemble the one-process state's flat vectors."""
    from imagdressing_tpu_torch.convert import tree_from_module

    from imagdressing_tpu_torch.models.unet import attn_layer_names

    models = dc.mini_models()
    rng = np.random.default_rng(0)
    # the trainables' own values, moments drawn once (nu = the square)
    trees = {"params": {}, "mu": {}, "nu": {}}
    for k in tstep.TRAINABLE_KEYS:
        tree = tree_from_module(getattr(models, k))
        if k == "ref_adapters":
            tree = {n: tree[n.replace(".", "_")]
                    for n in attn_layer_names(models.unet_cfg)}
        trees["params"][k] = _map(tree, lambda t: t.numpy())
        trees["mu"][k] = _map(tree, lambda t: rng.standard_normal(
            tuple(t.shape), dtype=np.float32))
        trees["nu"][k] = _map(trees["mu"][k], np.square)
    state, _, _ = tstep.init_train_state(models, dc.train_config())
    one = train_state_from_jax(state, trees["params"], mu=trees["mu"],
                               nu=trees["nu"], step=7, count=3)
    whole = dc._flat_host(one)
    assert one.step == 7 and one.opt_state.count == 3
    for data, model in ((2, 1), (1, 2)):
        parts = []
        for r in range(2):
            mesh = mesh_lib.Mesh(data=data, model=model, rank=r,
                                 device=torch.device("cpu"))
            # the ZeRO-2 parts load into whole modules: one stack serves
            models_r = models if data == 2 else dc.mini_models()
            st, _, _ = tstep.init_train_state(models_r, dc.train_config())
            if data == 2:
                layout = tstep.ZeroLayout(whole["params"].size, mesh)
            else:
                layout = tstep.TPLayout(st.params, mesh)
                for m in ("ref_unet", "ref_adapters"):
                    tp_lib.split_module(st.params[m], r, 2, None)
            st = dataclasses.replace(st, opt_state=tstep._map_opt(
                st.opt_state, layout.local_flat), layout=layout)
            parts.append(train_state_from_jax(
                st, trees["params"], mu=trees["mu"], nu=trees["nu"]))
        for what in ("mu", "nu"):
            local = [getattr(p.opt_state, what).float() for p in parts]
            if data == 2:
                got = torch.cat(local)[:whole[what].size]
            else:
                got = _tp_whole(parts[0].layout, local)
            np.testing.assert_array_equal(got.numpy(), whole[what])


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _tp_whole(layout, locals_):
    """The whole flat vector from both model ranks' local ones (what
    `TPLayout.host_flat` gathers)."""
    pieces = [loc.split([layout._local_numel(layout.entries[i])
                         for i in layout.order]) for loc in locals_]
    whole = [None] * len(layout.entries)
    for j, i in enumerate(layout.order):
        _, _, shape, kind = layout.entries[i]
        shards = []
        for r in range(2):
            local_shape = tp_lib.shard_tensor(kind, torch.empty(shape), r,
                                              2).shape
            shards.append(pieces[r][j].view(local_shape))
        whole[i] = tp_lib.unshard_tensor(kind, shards).reshape(-1)
    return torch.cat(whole)


def test_shard_host_batch_gives_each_rank_its_rows():
    """Each data rank's `data_iterator` rows (process_index = its data
    rank) land as tensors on its device, token ids int64; the ranks' rows
    together are the global batch of the epoch's order."""
    from imagdressing_tpu_torch.train.data import (
        data_iterator,
        shard_epoch_indices,
        shard_host_batch,
    )

    class Rows:
        def __len__(self):
            return 8

        def get(self, idx, epoch=0):
            return {"person_image": np.full((4, 4, 3), idx, np.float32),
                    "text_ids": np.full((77,), idx, np.int32)}

    got = []
    for r in range(2):
        mesh = mesh_lib.Mesh(data=2, model=1, rank=r,
                             device=torch.device("cpu"))
        it = data_iterator(Rows(), 2, seed=3, num_workers=1,
                           process_index=r, process_count=2)
        try:
            batch = shard_host_batch(mesh, next(it))
        finally:
            it.close()
        assert batch["text_ids"].dtype == torch.int64
        assert batch["person_image"].shape == (2, 4, 4, 3)
        got.append(batch["person_image"][:, 0, 0, 0].long().tolist())
    order = np.arange(8)
    np.random.default_rng(3).shuffle(order)
    for r in range(2):
        assert got[r] == list(shard_epoch_indices(order, r, 2, 2)[:2])


def test_plan_refuses_more_gpus_than_visible_and_cpu_ranks(monkeypatch):
    """--data_parallel / --tensor_parallel asking for more cards than are
    visible raise (no CPU device stands in); CPU ranks need
    --allow_cpu_mesh; -1 takes what there is."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(SystemExit, match=f"needs {n + 2} GPUs; {n} visible"):
        launch.plan(n + 2, 1, "cuda")
    with pytest.raises(SystemExit, match=f"needs {2 * (n + 1)} GPUs"):
        launch.plan(n + 1, 2, "cuda")
    with pytest.raises(SystemExit, match="allow_cpu_mesh"):
        launch.plan(2, 1, "cpu")
    assert launch.plan(2, 2, "cpu", allow_cpu_mesh=True) == (2, 2)
    assert launch.plan(-1, 1, "cpu") == (1, 1)
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert launch.plan(-1, 2, "cuda") == (2, 2)
    with pytest.raises(SystemExit, match="world of 4"):
        launch.plan(3, 1, "cuda")


def _fail_or_wait(tag: str) -> str:
    """Rank 1 fails at once; rank 0 waits for it in a barrier."""
    if os.environ["RANK"] == "1":
        raise ValueError(f"{tag}: rank 1 gives up")
    mesh_lib.init_from_env("gloo", device_type="cpu")
    mesh_lib.barrier(torch.distributed.group.WORLD)
    return tag


def test_spawn_raises_a_rank_error_and_kills_its_peers():
    """A rank's exception comes back with its traceback, at once: the peer
    that waits for it is killed, not left to its timeout."""
    import time

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        launch.spawn(_fail_or_wait, 2, ("probe",), timeout=60)
    assert time.perf_counter() - t0 < 30


def test_train_cli_over_two_ranks_writes_one_run(runs):
    """`train_cli --data_parallel 2`: rank 0 alone writes, one metrics
    line a step with the global batch's images/s, one checkpoint at step
    2 holding the whole (world-independent) state."""
    run = runs[3]["run"]
    lines = [json.loads(x) for x in
             (run / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [1, 2]
    for x in lines:
        assert np.isfinite(x["loss"]) and np.isfinite(x["grad_norm"])
        np.testing.assert_allclose(x["images_per_sec"],
                                   2 / x["step_time_s"], rtol=1e-6)
    assert ck.saved_steps(str(run / "checkpoints")) == [2]
    host, _ = ck.read_checkpoint(str(run / "checkpoints"), 2)
    n = sum(t.numel() for sd in host["params"].values() for t in sd.values())
    assert host["opt_state"]["mu"].numel() == n == \
        host["opt_state"]["nu"].numel()


def test_two_rank_run_resumes_on_one_and_serves(runs, monkeypatch, tmp_path):
    """The 2-rank run's checkpoint resumes in one process (one more step,
    a checkpoint at 3), and `dress --trained_ckpt` serves it."""
    paths = runs[3]
    run = paths["run"]
    _stub(monkeypatch)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        argv = list(paths["train_argv"])
        argv[argv.index("--num_train_steps") + 1] = "3"
        state = train_cli.main(argv + ["--resume_from_checkpoint",
                                       "--data_parallel", "1", "--device",
                                       "cpu"])
        assert state.step == 3 and state.layout is None
        assert ck.saved_steps(str(run / "checkpoints")) == [2, 3]
        garment = paths["dress_argv"][1] + "/g0.png"
        dress.main(["--cloth_path", garment, "--output_path", str(tmp_path),
                    "--trained_ckpt", str(run / "checkpoints"), "--device",
                    "cpu"] + DRESS)
    finally:
        torch.set_num_threads(n)
    assert os.listdir(tmp_path) == ["g0.png"]


def test_dress_over_two_ranks_matches_one_process(runs):
    """`dress --data_parallel 2`, 3 garments (batches of 2, the last
    padded), against one process at --batch_size 2: rank 0 alone wrote
    the same collages, within 1 level."""
    paths = runs[3]
    names = sorted(os.listdir(paths["dress2"]))
    assert names == ["g0.png", "g1.png", "g2.png"] == sorted(
        os.listdir(paths["dress1"]))
    for name in names:
        a = iu.read_image(str(paths["dress2"] / name)).astype(int)
        b = iu.read_image(str(paths["dress1"] / name)).astype(int)
        assert np.abs(a - b).max() <= 1, name


@pytest.mark.slow
def test_parallel_golden_is_current(golden):
    """The stored golden against a live recompute with the JAX package."""
    live = record_parallel_golden()
    assert set(live) == set(golden)
    for k, v in live.items():
        np.testing.assert_allclose(v, golden[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# The golden's recorder (the JAX package on 2 CPU devices)
# ---------------------------------------------------------------------------


def _jax_stack():
    """The mini stack as the JAX package's DressingModels (its weights
    converted with `tree_from_module`)."""
    import jax.numpy as jnp

    import imagdressing_tpu.core.config as jcfg
    from imagdressing_tpu.pipelines.dressing import DressingModels as JaxModels
    from imagdressing_tpu_torch.convert import tree_from_module
    from imagdressing_tpu_torch.models.unet import attn_layer_names

    models = dc.mini_models()
    params = {}
    for name, module in models.modules().items():
        tree = tree_from_module(module)
        if name == "ref_adapters":
            tree = {n: tree[n.replace(".", "_")]
                    for n in attn_layer_names(models.unet_cfg)}
        params[name] = _map(tree, lambda t: jnp.asarray(t.numpy()))
    cfgs = {k: getattr(jcfg, type(getattr(models, k)).__name__)(
        **dataclasses.asdict(getattr(models, k)))
        for k in ("unet_cfg", "vae_cfg", "text_cfg", "vision_cfg",
                  "resampler_cfg")}
    return JaxModels(**cfgs, params=params)


def _jax_schp_tree():
    """`dist_check.parser_net`'s weights and statistics as the JAX SCHP
    tree."""
    from imagdressing_tpu_torch.convert import tree_from_module

    net = dc.parser_net("cpu")
    tree = tree_from_module(net)

    def put(node, path, value):
        for part in path[:-1]:
            node = node[int(part)] if isinstance(node, list) else node[part]
        node[path[-1]] = value

    for name, buf in net.named_buffers():
        put(tree, name.split("."), buf)
    return _map(tree, lambda t: np.asarray(t.detach().numpy()))


def record_parallel_golden():
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from imagdressing_tpu.core import mesh as jmesh
    from imagdressing_tpu.core.config import TrainConfig as JaxTrainConfig
    from imagdressing_tpu.train import parsing_train as jptrain
    from imagdressing_tpu.train import step as jstep
    from imagdressing_tpu_torch.convert import _leaves

    cpus = jax.devices("cpu")[:2]
    jm = _jax_stack()
    cfg = JaxTrainConfig(train_batch_size=dc.TRAIN_B, warmup_steps=2,
                         learning_rate=1e-3)
    host = dc.train_batch()
    host["text_ids"] = host["text_ids"].astype(np.int32)
    rng = jax.random.PRNGKey(1)
    out = {}
    for step in (0, 1):
        keys = jstep._example_keys(rng, jnp.int32(step),
                                   jnp.arange(dc.TRAIN_B))
        ks = jax.vmap(lambda k: jax.random.split(k, 5))(keys)
        shape = (dc.TRAIN_HW // 8, dc.TRAIN_HW // 8, 4)

        def normal(i, shp):
            return jax.vmap(lambda k: jax.random.normal(k, shp, jnp.float32))(
                ks[:, i])

        out[f"draws{step}/eps_latents"] = normal(0, shape)
        out[f"draws{step}/eps_cloth"] = normal(1, shape)
        out[f"draws{step}/noise"] = normal(2, shape)
        out[f"draws{step}/noise_offset"] = normal(3, (1, 1, 4))
        out[f"draws{step}/timesteps"] = jax.vmap(
            lambda k: jax.random.randint(k, (), 0, 1000))(ks[:, 4])

    for kind in ("shard", "tp"):
        state, frozen, tx = jstep.init_train_state(jm, cfg)
        if kind == "shard":
            mesh = jmesh.make_mesh(devices=cpus)
            fn, state, frozen = jstep.shard_train_step(jm, cfg, tx, mesh,
                                                       state, frozen)
        else:
            mesh = jmesh.make_mesh(data=1, model=2, devices=cpus)
            fn, state, frozen = jstep.tp_train_step(jm, cfg, tx, mesh,
                                                    state, frozen)
        batch = jax.device_put({k: jnp.asarray(v) for k, v in host.items()},
                               NamedSharding(mesh, P(jmesh.DATA_AXIS)))
        key = jax.device_put(rng, NamedSharding(mesh, P()))
        with mesh:
            for i in (1, 2):
                state, m = fn(state, frozen, batch, key)
                out[f"{kind}/step{i}/loss"] = m["loss"]
                out[f"{kind}/step{i}/grad_norm"] = m["grad_norm"]
        flat = {"/".join(p): a for p, a in _leaves(
            {k: jax.tree.map(np.asarray, v)
             for k, v in state.params.items()})}
        for leaf in TRAIN_LEAVES:
            out[f"{kind}/step2/{leaf}"] = flat[leaf]

    pcfg = jptrain.ParsingTrainConfig(num_classes=dc.PARSER_CLASSES,
                                      learning_rate=2e-2, total_steps=100,
                                      lovasz_weight=0.0)
    mesh = jmesh.make_mesh(devices=cpus)
    tree = _jax_schp_tree()
    fn, params, opt_state, _ = jptrain.shard_parsing_train_step(
        pcfg, mesh, jax.tree.map(jnp.asarray, tree))
    pbatch = jax.device_put(
        {k: jnp.asarray(v) for k, v in dc.parser_batch().items()},
        NamedSharding(mesh, P(jmesh.DATA_AXIS)))
    with mesh:
        params, _, m = fn(params, opt_state, jnp.int32(0), pbatch)
    out["parser/loss"] = m["loss"]
    from imagdressing_tpu_torch.convert import _convert_leaf

    def port_layout(tree):
        return dict(_convert_leaf(p, a) for p, a in _leaves(tree))

    before = port_layout(tree)
    after = port_layout(jax.tree.map(np.asarray, params))
    for k in dc.PARSER_LEAVES:
        out[f"parser/update/{k}"] = (after[k] - before[k]).numpy()
    for k in dc.PARSER_STATS:
        out[f"parser/stat/{k}"] = after[k].numpy()
    return {k: np.asarray(v) for k, v in out.items()}


if __name__ == "__main__":
    import jax

    # the settings tests/conftest.py gives the suite
    os.environ.setdefault("IMAGDRESSING_DISABLE_PALLAS", "1")
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_threefry_partitionable", True)
    np.savez_compressed(GOLDEN, **record_parallel_golden())
    print("wrote", GOLDEN, os.path.getsize(GOLDEN), "bytes")
