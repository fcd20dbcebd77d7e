"""Two full SCHP fine-tune steps of the port against JAX's jitted
`make_parsing_train_step`, on the CPU: the full-width, full-depth net at
64x64 (batch 2, 6 classes: `tests/test_parsing_train.py`'s shape), from the
same weights (`convert.state_dict_from_jax`). Its own file: tracing and
compiling JAX's step takes ~20-25 s cold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import imagdressing_tpu.train.parsing_train as jtrain
from imagdressing_tpu.preprocess.parsing import model as jschp
from imagdressing_tpu_torch.convert import state_dict_from_jax
from imagdressing_tpu_torch.preprocess.parsing import model as pschp
from imagdressing_tpu_torch.train import parsing_train as ptrain

NUM_CLASSES = 6


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)




def _numpy_tree(tree):
    """A JAX tree (params or optax's trace) as numpy, optax's MaskedNode
    leaves (the frozen running statistics) as None."""
    return jax.tree.map(
        lambda v: None if isinstance(v, optax.MaskedNode) else np.asarray(v),
        tree, is_leaf=lambda v: isinstance(v, optax.MaskedNode))


def test_two_train_steps_match_jax():
    """The full-width, full-depth SCHP (119 ABNs in train mode), 64x64,
    batch 2, 6 classes, lr 2e-2 over 100 steps: two steps of JAX's jitted
    step and of the port's, each port step from JAX's state before it (the
    parameters, running statistics and momentum trace). Per step: the loss;
    every parameter's gradient (the port's `.grad` against JAX's, read off
    optax's trace: trace_after - 0.9 * trace_before - wd * param), each
    leaf and all leaves in L2; the update the optimizer made from it; the
    running statistics.

    Conditioning: at `schp.init`'s weights (bn3.weight = 1) the train-mode
    net amplifies fp32 rounding ~1e5x (a 1e-7 relative input change moves
    JAX's fusion logits by 6.4e-3; the gradients of the port and JAX differ
    by 36 % in L2). With every bottleneck's last BN scaled to gamma 0.25 the
    logits' sensitivity is 1.1e-4 (gamma 0.1: 9.8e-5, gamma 0: 8e-5) and
    every residual branch stays live. A leaf's gradient is still a small
    difference of large BN-backward sums, so rounding alone moves it:
    two compiles of JAX's own ResNet trunk (default and
    `xla_backend_optimization_level` 0) differ by 1.8 % in L2, and one
    element can move by 40 % of a leaf's max, so the elementwise max is not
    held. Each bottleneck's math is held leaf by leaf at 1e-5 in
    `test_torch_parsing_train.py::test_train_bottleneck_matches_jax`.
    Measured (steps 0, 1): loss 1.3e-6, 1.2e-6 relative; all gradients
    3.0e-2, 3.6e-2 in L2; the worst leaf 4.4e-2, 6.3e-2 in L2; running
    statistics 9.7e-4, 1.1e-3 absolute. Tolerances: loss 3e-6, all 8e-2,
    each leaf 0.15, statistics 3e-3; the update equal to JAX's plus -lr
    times the gradients' difference, within 1e-4 of its max and two fp32
    roundings of the parameter."""
    tree = jschp.init(jax.random.PRNGKey(0), num_classes=NUM_CLASSES)
    for li in range(1, 5):
        for block in tree[f"layer{li}"]:
            block["bn3"]["weight"] = np.full_like(block["bn3"]["weight"],
                                                  0.25)
    rng = np.random.default_rng(0)
    b, h, w = 2, 64, 64
    batch = {"image": rng.standard_normal((b, h, w, 3)).astype(np.float32),
             "label": rng.integers(0, NUM_CLASSES, (b, h, w)).astype(
                 np.int32)}
    batch["edge"] = jtrain.edges_from_labels(batch["label"])
    kw = dict(num_classes=NUM_CLASSES, learning_rate=2e-2, total_steps=100)

    cfg = jtrain.ParsingTrainConfig(**kw)
    tx = jtrain.make_optimizer(cfg)
    params, opt_state = tree, tx.init(tree)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    # XLA's backend optimisations off: ~4 s less compile
    jstep = jax.jit(jtrain.make_parsing_train_step(cfg, tx)).lower(
        params, opt_state, jnp.int32(0), jbatch).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    trees, traces, jlosses = [tree], [None], []
    for i in range(2):
        params, opt_state, m = jstep(params, opt_state, jnp.int32(i), jbatch)
        trees.append(_numpy_tree(params))
        traces.append(_numpy_tree(
            opt_state.inner_states["train"].inner_state[1].trace))
        jlosses.append(float(m["loss"]))

    with torch.device("meta"):  # filled from JAX's state before each step
        net = pschp.SCHP(NUM_CLASSES)
    net.to_empty(device="cpu")
    pcfg = ptrain.ParsingTrainConfig(**kw)
    opt = ptrain.make_optimizer(pcfg, net)
    step = ptrain.make_parsing_train_step(pcfg, net, opt)
    schedule = ptrain.lr_schedule(pcfg)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    named = dict(net.named_parameters())
    sds = [state_dict_from_jax(t) for t in trees]
    trace_sds = [None] + [state_dict_from_jax(t) for t in traces[1:]]
    for i in range(2):
        net.load_state_dict(sds[i])
        if trace_sds[i] is not None:
            for k, v in trace_sds[i].items():
                opt.state[named[k]]["momentum_buffer"] = v.clone()
        loss = float(step(i, tbatch)["loss"])
        assert abs(loss - jlosses[i]) <= 3e-6 * abs(jlosses[i]), i
        jb, ja = sds[i:i + 2]
        for k, v in net.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                assert (v - ja[k]).abs().max() <= 3e-3, (i, k)
        sq_err = sq_ref = 0.0
        for k, p in named.items():
            trace_before = (0 if trace_sds[i] is None
                            else pcfg.momentum * trace_sds[i][k])
            want = (trace_sds[i + 1][k] - trace_before
                    - pcfg.weight_decay * jb[k])
            err = p.grad - want
            assert err.norm() <= 0.15 * want.norm(), (i, k)
            sq_err += float((err * err).sum())
            sq_ref += float((want * want).sum())
            # the port's SGD applied that gradient as optax did JAX's (up
            # to the rounding of each side's fp32 parameter)
            du = (p.detach() - ja[k]) + schedule(i) * err
            assert du.abs().max() <= (1e-4 * (ja[k] - jb[k]).abs().max()
                                      + 2.5e-7 * ja[k].abs().max()), (i, k)
        assert (sq_err / sq_ref) ** 0.5 <= 8e-2, i
