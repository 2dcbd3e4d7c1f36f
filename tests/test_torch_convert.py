"""The port's weight loaders (``vitvs_tpu_torch/models/convert.py``): the
exported trained ViT-S/14 @ 518 (``vitvs_tpu_torch/assets/ckpt_real518.npz``,
written by ``scripts/export_port_weights.py``) against the orbax checkpoint
it came from, and the torch-hub state-dict loaders against ``vitvs_tpu``'s
on a ``tests/torch_ref.py:TorchViT`` state dict."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ref import TorchViT
from vitvs_tpu.models import convert as jconvert
from vitvs_tpu.models import extractor as jext
from vitvs_tpu_torch.models import convert as tconvert
from vitvs_tpu_torch.models import extractor as text
from vitvs_tpu_torch.models import vit as tvit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_exported_weights_equal_the_orbax_checkpoint_bit_for_bit():
    """The committed npz loads, with numpy alone, into the state dict of
    from_jax_params(load_params(artifacts/ckpt_real518)) with the embedding
    equal bit for bit (f32) and the blocks equal bit for bit to its values
    rounded to bf16; so the ViT the bf16 step runs (``load_vit``: the
    blocks in bf16, the embedding in f32) is the same bit for bit from
    either file.  Its config is ViT-S/14 at 37 x 37 positions."""
    from vitvs_tpu_torch.harness.pipeline import ServoModel
    from vitvs_tpu_torch.io_bridge.config import VSConfig

    assert tconvert.TRAINED_S518 == Path(REPO, "vitvs_tpu_torch", "assets", "ckpt_real518.npz")
    sd, cfg = tconvert.load_exported(tconvert.TRAINED_S518)
    assert cfg == tvit.make_config("dinov2_vits14")
    ref = tconvert.from_jax_params(jax.tree.map(
        np.asarray, jconvert.load_params(os.path.join(REPO, "artifacts", "ckpt_real518"))))
    # the file holds the facet path's weights: not the final norm, which
    # from_jax_params carries (vit_forward reads it)
    assert {k for k in ref if k not in sd} == {"norm.weight", "norm.bias"}
    ref = {k: v for k, v in ref.items() if k in sd}
    assert sorted(sd) == sorted(ref) and len(sd) == 172
    for k, v in ref.items():
        want = v.to(torch.bfloat16) if k.startswith("blocks.") else v
        assert sd[k].dtype == want.dtype and torch.equal(sd[k], want), k
    model = ServoModel.create(VSConfig(pinv_mode="dls", dino_input_size=518), device="cpu")
    got, net = model.load_vit(sd).state_dict(), model.load_vit(ref).state_dict()
    assert sorted(got) == sorted(net)
    for k, v in net.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert got["blocks.0.attn.qkv.weight"].dtype == torch.bfloat16
    assert got["pos_embed"].dtype == torch.float32
    with np.load(tconvert.TRAINED_S518, allow_pickle=False) as f:
        meta = str(f[tconvert.EXPORTED_CONFIG_KEY])
        assert f["blocks.0.mlp.fc1.weight"].shape == (2, 1536, 384)
    assert '"source": "ckpt_real518"' in meta and '"blocks_dtype": "bfloat16"' in meta


def test_load_exported_needs_neither_jax_nor_the_reference():
    code = ("import sys; from vitvs_tpu_torch.models.convert import load_exported, TRAINED_S518; "
            "sd, cfg = load_exported(TRAINED_S518); "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'vitvs_tpu', 'orbax')]; "
            "assert not bad, bad; print(len(sd))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "172"


def test_load_exported_refuses_what_it_cannot_read(tmp_path):
    with pytest.raises(FileNotFoundError):
        tconvert.load_exported(tmp_path / "missing.npz")
    np.savez(tmp_path / "bare.npz", w=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="__config__"):
        tconvert.load_exported(tmp_path / "bare.npz")
    config = '{"blocks_dtype": "float16"}'
    np.savez(tmp_path / "f16.npz", __config__=np.array(config), w=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="blocks_dtype"):
        tconvert.load_exported(tmp_path / "f16.npz")
    # f32 blocks are read (the trainer writes them), but not without the architecture
    config = '{"blocks_dtype": "float32"}'
    np.savez(tmp_path / "f32.npz", __config__=np.array(config), w=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="lacks"):
        tconvert.load_exported(tmp_path / "f32.npz")
    (tmp_path / "junk.npz").write_bytes(b"not a zip")
    with pytest.raises(ValueError):
        tconvert.load_exported(tmp_path / "junk.npz")


def _hub_state_dict(layerscale_name="ls1.gamma", seed=0, **kw):
    """A TorchViT state dict at a tiny width (128, two heads of 64, the head
    count infer_config reads from the width) with LayerScale and biases away
    from their init, LayerScale spelled ``ls1.gamma`` (DINOv2) or
    ``gamma_1`` (the legacy name), plus the keys the facet path drops."""
    torch.manual_seed(seed)
    m = TorchViT(patch=14, dim=128, depth=2, heads=2, pos_grid=5, **kw)
    sd = {k: v.detach().clone() for k, v in m.state_dict().items()}
    g = torch.Generator().manual_seed(seed + 1)
    for k in sd:
        if k.endswith("gamma"):
            sd[k] = 0.5 + torch.rand(sd[k].shape, generator=g)
        elif k.endswith("bias"):
            sd[k] = 0.1 * torch.randn(sd[k].shape, generator=g)
    if layerscale_name == "gamma_1":
        sd = {k.replace("ls1.gamma", "gamma_1").replace("ls2.gamma", "gamma_2"): v
              for k, v in sd.items()}
    sd["mask_token"] = torch.zeros(1, 128)
    return sd


@pytest.mark.parametrize("name", ["ls1.gamma", "gamma_1"])
def test_from_torch_state_dict_reads_both_layerscale_spellings(name):
    hub = _hub_state_dict(name)
    sd, cfg = tconvert.from_torch_state_dict(hub)
    assert cfg == tvit.ViTConfig(patch_size=14, embed_dim=128, depth=2, num_heads=2, pos_grid=5,
                                 use_layerscale=True, stride=14, model_name="custom_vit_d128_p14")
    assert sorted(sd) == sorted(tvit.ViT(cfg).state_dict())
    ref, _ = tconvert.from_torch_state_dict(_hub_state_dict("ls1.gamma"))
    for k, v in ref.items():
        assert torch.equal(sd[k], v), k
    assert not torch.equal(sd["blocks.1.ls2.gamma"], torch.ones(128))
    gamma = hub["blocks.1.ls2.gamma" if name == "ls1.gamma" else "blocks.1.gamma_2"]
    assert torch.equal(sd["blocks.1.ls2.gamma"], gamma)


def test_from_torch_state_dict_defaults_missing_layerscale_to_ones():
    hub = {k: v for k, v in _hub_state_dict().items() if "gamma" not in k}
    sd, cfg = tconvert.from_torch_state_dict(hub, stride=7)
    assert not cfg.use_layerscale and cfg.stride == 7
    assert all(torch.equal(sd[f"blocks.{i}.ls{n}.gamma"], torch.ones(128))
               for i in range(2) for n in (1, 2))


def test_from_torch_file_unwraps_model_and_module_prefixes(tmp_path):
    hub = _hub_state_dict()
    path = tmp_path / "hub.pth"
    torch.save({"model": {"module." + k: v for k, v in hub.items()}}, path)
    sd, cfg = tconvert.from_torch_file(path)
    ref, ref_cfg = tconvert.from_torch_state_dict(hub)
    assert cfg == ref_cfg and sorted(sd) == sorted(ref)
    assert all(torch.equal(sd[k], ref[k]) for k in ref)


def test_infer_config_checks_presets_and_refuses_swiglu():
    """A preset is checked against the shapes, the FFN's family among them:
    a SwiGLU state dict is refused as a GELU preset and read as SwiGLU
    otherwise (its hidden width from mlp.w3)."""
    hub = _hub_state_dict()
    with pytest.raises(ValueError, match="do not match preset dinov2_vits14"):
        tconvert.infer_config(hub, "dinov2_vits14")
    torch.manual_seed(0)
    small = TorchViT(patch=14, dim=384, depth=12, heads=6, pos_grid=37).state_dict()
    assert tconvert.infer_config(small, "dinov2_vits14") == tvit.make_config("dinov2_vits14")
    swiglu = TorchViT(patch=14, dim=96, depth=1, heads=3, pos_grid=5, swiglu=True).state_dict()
    _, cfg = tconvert.from_torch_state_dict(swiglu)
    assert (cfg.ffn, cfg.ffn_hidden) == ("swiglu", 256)
    small_g = {k.replace("mlp.fc1", "mlp.w12").replace("mlp.fc2", "mlp.w3"): v
               for k, v in small.items()}
    with pytest.raises(ValueError, match="do not match preset dinov2_vits14"):
        tconvert.infer_config(small_g, "dinov2_vits14")


@pytest.mark.parametrize("bin", [False, True], ids=["token", "binned"])
def test_descriptors_from_a_hub_state_dict_match_the_reference(bin):
    """vitvs_tpu's from_torch_state_dict and the port's, on the same hub
    state dict (``ls1.gamma`` spelling, which both read; the reference reads
    no ``gamma_1``), give the same f32 layer-1 descriptors of a 56 px image
    within 2e-5 (f32 sums in other orders; descriptors of O(1))."""
    hub = _hub_state_dict()
    jparams, jcfg = jconvert.from_torch_state_dict(hub)
    sd, cfg = tconvert.from_torch_state_dict(hub)
    assert (cfg.embed_dim, cfg.depth, cfg.num_heads) == (jcfg.embed_dim, jcfg.depth, 2)
    net = tvit.ViT(cfg)
    net.load_state_dict(sd)
    img = np.random.default_rng(4).standard_normal((1, 56, 56, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, x: jext.extract_descriptors(
        p, jcfg, x, layer=1, bin=bin))(jparams, jnp.asarray(img)))
    out = text.extract_descriptors(net.eval(), torch.from_numpy(img), layer=1, bin=bin,
                                   use_kernels=False).detach().numpy()
    assert out.shape == ref.shape == (1, 1, 16, 128 * (9 if bin else 1))
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)
