"""The port's checkpoint converters, safetensors reader, writer and loader
against the JAX package.

One tiny port stack (`DressingModels.init_random(0, small=True,
with_controlnet=True, with_ipa=True)`, fp32) goes into the reference's files
through `tools/write_checkpoints.py`, with a rank-4 FaceID LoRA. The same
files (and a tiny transformers `CLIPTextModel`'s state dict) go through the
JAX package's `convert/torch_sd.py` and the port's copy, the stack's trees
through both packages' exporters: every leaf equal.
JAX's `apps.loader.load_dressing_models(..., dtype=None)` and the port's
(`device="cpu"`) load the files: the port's state dicts equal
`params_from_jax` of JAX's tree, exactly (the LoRA fold within 1e-6). The
files load back into the stack that wrote them bit for bit, in fp32 and
bf16. No JAX pipeline runs here (numpy conversion only).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from imagdressing_tpu.apps import loader as jloader
from imagdressing_tpu.convert import export_torch as jex
from imagdressing_tpu.convert import torch_sd as jcv
from imagdressing_tpu.core import config as jcfg
from imagdressing_tpu_torch.apps.loader import load_dressing_models
from imagdressing_tpu_torch.convert import (
    params_from_jax,
    state_dict_from_jax,
    tree_from_module,
)
from imagdressing_tpu_torch.convert import export_torch as ex
from imagdressing_tpu_torch.convert import torch_sd as cv
from imagdressing_tpu_torch.core.config import ControlNetConfig, UNetConfig
from imagdressing_tpu_torch.pipelines.dressing import (
    DressingModels,
    model_configs,
)
from imagdressing_tpu_torch.tools.write_checkpoints import (
    random_lora,
    write_checkpoints,
)

CONFIGS = model_configs(small=True)
_JAX_CLASSES = dict(unet_cfg=jcfg.UNetConfig, vae_cfg=jcfg.VAEConfig,
                    text_cfg=jcfg.CLIPTextConfig,
                    vision_cfg=jcfg.CLIPVisionConfig,
                    resampler_cfg=jcfg.ResamplerConfig,
                    projplus_cfg=jcfg.ProjPlusConfig)
JAX_CONFIGS = {k: _JAX_CLASSES[k](**dataclasses.asdict(v))
               for k, v in CONFIGS.items()}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stack():
    return DressingModels.init_random(0, small=True, with_controlnet=True,
                                      with_ipa=True, device="cpu")


@pytest.fixture(scope="module")
def files(stack, tmp_path_factory):
    """The stack's files, with a rank-4 LoRA in the FaceID bin."""
    root = tmp_path_factory.mktemp("ckpt")
    return write_checkpoints(stack, str(root), lora=random_lora(stack, 4))


def _assert_trees_equal(got, want, path="") -> int:
    """Same structure, every leaf equal (as float32 numpy); returns the
    leaf count."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        return sum(_assert_trees_equal(got[k], want[k], f"{path}/{k}")
                   for k in want)
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        return sum(_assert_trees_equal(g, w, f"{path}/{i}")
                   for i, (g, w) in enumerate(zip(got, want)))
    g = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert g.shape == want.shape, (path, g.shape, want.shape)
    np.testing.assert_array_equal(g, want, err_msg=path)
    return 1


def _hf_clip_text_state_dict():
    transformers = pytest.importorskip("transformers")
    c = CONFIGS["text_cfg"]
    model = transformers.CLIPTextModel(transformers.CLIPTextConfig(
        vocab_size=c.vocab_size, hidden_size=c.hidden_size,
        intermediate_size=c.intermediate_size,
        num_hidden_layers=c.num_layers, num_attention_heads=c.num_heads,
        max_position_embeddings=c.max_position_embeddings))
    return model.state_dict()


def _legacy_vae(sd):
    """The VAE's attention under the legacy diffusers names."""
    names = {".to_q.": ".query.", ".to_k.": ".key.", ".to_v.": ".value.",
             ".to_out.0.": ".proj_attn."}
    out = {}
    for k, v in sd.items():
        if ".attentions." in k:
            for new, old in names.items():
                k = k.replace(new, old)
        out[k] = v
    return out


def _case(name, files):
    """(port converter call, JAX converter call) on one file's dict."""
    u, ju = CONFIGS["unet_cfg"], JAX_CONFIGS["unet_cfg"]
    load = cv.load_torch_file
    if name == "unet":
        sd = load(f"{files['base_dir']}/unet/"
                  "diffusion_pytorch_model.safetensors")
        return cv.convert_unet(sd, u), jcv.convert_unet(sd, ju)
    if name in ("vae", "vae_legacy_names"):
        sd = load(f"{files['vae_path']}/diffusion_pytorch_model.safetensors")
        if name == "vae_legacy_names":
            sd = _legacy_vae(sd)
        return (cv.convert_vae(sd, CONFIGS["vae_cfg"]),
                jcv.convert_vae(sd, JAX_CONFIGS["vae_cfg"]))
    if name in ("clip_text", "clip_text_transformers"):
        sd = _hf_clip_text_state_dict() if name.endswith("transformers") \
            else load(f"{files['base_dir']}/text_encoder/model.safetensors")
        return (cv.convert_clip_text(sd, CONFIGS["text_cfg"]),
                jcv.convert_clip_text(sd, JAX_CONFIGS["text_cfg"]))
    if name == "clip_vision":
        sd = load(f"{files['image_encoder_path']}/model.safetensors")
        return (cv.convert_clip_vision(sd, CONFIGS["vision_cfg"]),
                jcv.convert_clip_vision(sd, JAX_CONFIGS["vision_cfg"]))
    if name == "controlnet":
        sd = load(f"{files['controlnet_path']}/"
                  "diffusion_pytorch_model.safetensors")
        return (cv.convert_controlnet(sd, ControlNetConfig(unet=u)),
                jcv.convert_controlnet(sd, jcfg.ControlNetConfig(unet=ju)))
    if name == "imagdressing_split":
        sd = load(files["model_ckpt"])["module"]
        args = (sd, u, CONFIGS["resampler_cfg"])
        jargs = (sd, ju, JAX_CONFIGS["resampler_cfg"])
        return (cv.convert_imagdressing_checkpoint(*args),
                jcv.convert_imagdressing_checkpoint(*jargs))
    if name == "resampler":
        sd = {k[len("proj."):]: v for k, v in
              load(files["model_ckpt"])["module"].items()
              if k.startswith("proj.")}
        return (cv.convert_resampler(sd, CONFIGS["resampler_cfg"]),
                jcv.convert_resampler(sd, JAX_CONFIGS["resampler_cfg"]))
    if name == "ip_adapter_faceid_lora":
        sd = load(files["ip_ckpt"])
        return (cv.convert_ip_adapter_faceid(sd, u, CONFIGS["projplus_cfg"]),
                jcv.convert_ip_adapter_faceid(sd, ju,
                                              JAX_CONFIGS["projplus_cfg"]))
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "unet", "vae", "vae_legacy_names", "clip_text", "clip_text_transformers",
    "clip_vision", "controlnet", "resampler", "imagdressing_split",
    "ip_adapter_faceid_lora"])
def test_converter_matches_jax(files, name):
    """The port's copy of each converter gives JAX's tree on the same state
    dict: same structure, every leaf equal (the port keeps torch tensors,
    JAX widens them to fp32 numpy)."""
    got, want = _case(name, files)
    assert _assert_trees_equal(got, want) > 10


@pytest.mark.parametrize("name", ["unet", "resampler", "imagdressing_module",
                                  "imagdressing_module_with_unet"])
def test_export_matches_jax(files, tmp_path, name):
    """The port's copy of the JAX package's exporters on the same numpy
    trees (JAX's conversion of the stack's files): the same names, every
    tensor equal; `save_checkpoint` writes what JAX's writes."""
    split = jcv.convert_imagdressing_checkpoint(
        cv.load_torch_file(files["model_ckpt"])["module"],
        JAX_CONFIGS["unet_cfg"], JAX_CONFIGS["resampler_cfg"])
    unet = _case("unet", files)[1]
    if name == "unet":
        got, want = ex.export_unet(unet), jex.export_unet(unet)
    elif name == "resampler":
        got = ex.export_resampler(split["resampler"])
        want = jex.export_resampler(split["resampler"])
    else:
        params = dict(split, unet=unet) if name.endswith("with_unet") \
            else split
        got = ex.export_imagdressing_module(params, CONFIGS["unet_cfg"])
        want = jex.export_imagdressing_module(params,
                                              JAX_CONFIGS["unet_cfg"])
        ex.save_checkpoint(str(tmp_path / "port.pt"), got)
        jex.save_checkpoint(str(tmp_path / "jax.pt"), want)
        a = torch.load(tmp_path / "port.pt")["module"]
        b = torch.load(tmp_path / "jax.pt")["module"]
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert got.keys() == want.keys() and len(want) > 10
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_adapter_module_index_map_matches_jax():
    for cfg in (CONFIGS["unet_cfg"], UNetConfig()):
        port = cv.adapter_module_index_map(cfg)
        assert port == jcv.adapter_module_index_map(
            jcfg.UNetConfig(**dataclasses.asdict(cfg)))
        assert len(port) == 32 and port[0][1].endswith("attn1.processor")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16, torch.int64])
def test_safetensors_reader_matches_the_package(tmp_path, dtype):
    """The port's reader against `safetensors.safe_open` on the package's
    file, and the package against the port's writer: bit-equal, for each
    dtype the reader covers (a scalar, an empty and a 3-d tensor too)."""
    st = pytest.importorskip("safetensors.torch")
    from safetensors import safe_open

    gen = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn(3, 5, 7, generator=gen),
               "b.weight": torch.randn(4, generator=gen) * 1e3,
               "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 3)}
    tensors = {k: (v * 100).to(dtype) for k, v in tensors.items()}
    theirs, ours = tmp_path / "theirs.safetensors", \
        tmp_path / "ours.safetensors"
    st.save_file(tensors, str(theirs), metadata={"format": "pt"})
    cv.write_safetensors(str(ours), tensors)
    got = cv.read_safetensors(str(theirs))
    with safe_open(str(ours), framework="pt") as f:
        assert set(f.keys()) == set(tensors)
        for k, t in tensors.items():
            back = f.get_tensor(k)
            assert back.dtype == dtype and torch.equal(back, t), k
            assert got[k].dtype == dtype and torch.equal(got[k], t), k
    assert set(got) == set(tensors)


@pytest.mark.parametrize("case", ["ckpt", "ckpt_lora_0.7", "no_model_ckpt"])
def test_loader_matches_jax(files, case):
    """Both loaders on the same files, fp32 (dtype=None): the port's state
    dicts equal `params_from_jax` of JAX's tree exactly; the FaceID LoRA
    fold within 1e-6. Without `model_ckpt` the garment UNet copies the base
    and the adapters its attn1 to_k/to_v in both; only the randomly
    initialised Resampler differs (another generator)."""
    kw = {"ckpt": {}, "ckpt_lora_0.7": {"lora_scale": 0.7},
          "no_model_ckpt": {"model_ckpt": None}}[case]
    paths = {**files, **kw}
    jm = jloader.load_dressing_models(**paths, dtype=None, **JAX_CONFIGS)
    pm = load_dressing_models(**paths, dtype=None, device="cpu", **CONFIGS)
    want = params_from_jax(jax.tree.map(np.asarray, jm.params))
    assert set(want) == set(pm.modules())
    for name, sd in want.items():
        got = getattr(pm, name).state_dict()
        assert got.keys() == sd.keys(), name
        if case == "no_model_ckpt" and name == "resampler":
            continue
        tol = 1e-6 if name == "unet" and "lora" in case else 0.0
        for k, v in sd.items():
            assert got[k].dtype == torch.float32
            err = float((got[k] - v).abs().max()) if v.numel() else 0.0
            assert err <= tol, (name, k, err)
    if case == "ckpt_lora_0.7":  # the fold changed the UNet
        base = load_dressing_models(**files, dtype=None, device="cpu",
                                    **CONFIGS)
        assert not torch.equal(base.unet.down_blocks[0].attentions[0]
                               .transformer_blocks[0].attn1.to_q.weight,
                               pm.unet.down_blocks[0].attentions[0]
                               .transformer_blocks[0].attn1.to_q.weight)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_written_files_load_back_bit_equal(stack, tmp_path, dtype):
    """writer -> files -> loader gives the writing stack back, every
    parameter bit-equal and in its dtype, conv weights channels_last."""
    models = stack
    if dtype != torch.float32:
        models = DressingModels.init_random(
            0, small=True, with_controlnet=True, with_ipa=True,
            device="cpu").cast(dtype)
    paths = write_checkpoints(models, str(tmp_path))
    got = load_dressing_models(**paths, dtype=dtype, device="cpu", **CONFIGS)
    assert set(got.modules()) == set(models.modules())
    for name, module in models.modules().items():
        want = module.state_dict()
        have = getattr(got, name).state_dict()
        assert have.keys() == want.keys(), name
        for k, v in want.items():
            assert have[k].dtype == dtype and torch.equal(have[k], v), \
                (name, k)
    assert got.unet.conv_in.weight.is_contiguous(
        memory_format=torch.channels_last)


def test_tree_from_module_inverts_state_dict_from_jax(stack):
    for name, module in stack.modules().items():
        sd = state_dict_from_jax(tree_from_module(module))
        want = module.state_dict()
        assert sd.keys() == want.keys(), name
        assert all(torch.equal(sd[k], want[k]) for k in want), name


def test_loader_defaults_to_cuda(files):
    """Without a card the loader raises unless device='cpu' is given."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_dressing_models(**files, **CONFIGS)


def test_from_state_dicts_needs_every_model(stack):
    sds = {n: m.state_dict() for n, m in stack.modules().items()
           if n != "vae"}
    with pytest.raises(KeyError, match="vae"):
        DressingModels.from_state_dicts(sds, CONFIGS, device="cpu")
