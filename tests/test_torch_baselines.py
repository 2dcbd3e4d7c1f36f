"""Port parity of the pixel baselines (``models/baselines.py``) and of the
exact attention at any head width: configs and descriptors against
vitvs_tpu's with the weights carried across, the port's own init, the
pixel8 episode's first twists with JAX's pair scores injected, the plain
attention against the JAX Pallas kernel in interpret mode at the pixel
models' head widths, and the wrappers' routing of head widths other than 64
(the any-width kernel) and refusals (the no-max and int8 kernels), checked
before any launch."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_rollout import GOAL_POS, GOAL_QUAT, rollout_scores  # noqa: E402

from vitvs_tpu.harness import pipeline as jpipe  # noqa: E402
from vitvs_tpu.harness import rollout as jroll  # noqa: E402
from vitvs_tpu.io_bridge.config import VSConfig as JVSConfig  # noqa: E402
from vitvs_tpu.models import baselines as jbase  # noqa: E402
from vitvs_tpu.models import extractor as jext  # noqa: E402
from vitvs_tpu.models import vit as jvit  # noqa: E402
from vitvs_tpu.ops.attention import mha_attention as jattention  # noqa: E402
from vitvs_tpu.sim import Scene as JScene  # noqa: E402
from vitvs_tpu.sim import make_synthetic_poster, observe as jobserve  # noqa: E402
from vitvs_tpu_torch.harness import benchmark as tbench  # noqa: E402
from vitvs_tpu_torch.harness import pipeline as tpipe  # noqa: E402
from vitvs_tpu_torch.harness import rollout as troll  # noqa: E402
from vitvs_tpu_torch.io_bridge.config import VSConfig as TVSConfig  # noqa: E402
from vitvs_tpu_torch.models import baselines as tbase  # noqa: E402
from vitvs_tpu_torch.models import extractor as text  # noqa: E402
from vitvs_tpu_torch.models import vit as tvit  # noqa: E402
from vitvs_tpu_torch.models.convert import from_jax_params  # noqa: E402
from vitvs_tpu_torch.ops import _build, attention, attn_int8  # noqa: E402
from vitvs_tpu_torch.sim.scene import Scene as TScene  # noqa: E402

RNG = np.random.default_rng(23)


@pytest.fixture(autouse=True)
def _fresh_rng():
    """Each test draws its inputs from the same seed, whatever ran before it."""
    global RNG
    RNG = np.random.default_rng(23)
# tests/test_baselines.py's pixel8 episode
EPISODE_CFG = dict(u_max=128, v_max=128, f_x=100.5, f_y=100.5, dino_input_size=112,
                   num_pairs=16, lambda_=0.5, control_dt=0.1, ema_alpha=0.8,
                   model_name="pixel8", layer=0, pinv_mode="dls", max_iterations=120)


def _carried(name: str):
    """JAX's init_pixel_params of ``name`` and the port's ViT holding them (f32)."""
    jcfg = jbase.pixel_config(name)
    params = jax.tree.map(np.asarray, jbase.init_pixel_params(jcfg))
    net = tvit.ViT.from_state_dict(tbase.pixel_config(name), from_jax_params(params))
    return jcfg, params, net.eval()


@pytest.mark.parametrize("name", ["pixel4", "pixel8", "pixel14", "pixel16"])
def test_pixel_configs_match_jax(name):
    """Every field the two ViTConfigs share is equal; make_config takes the
    name, ignores a stride (as the JAX package does) and names pixel<P>
    among the options it lists."""
    j, t = jbase.pixel_config(name), tbase.pixel_config(name)
    shared = {f.name for f in dataclasses.fields(t)} & {f.name for f in dataclasses.fields(j)}
    assert {k: getattr(t, k) for k in shared} == {k: getattr(j, k) for k in shared}
    assert tvit.make_config(name, stride=2) == t == tvit.make_config(name)
    assert t.head_dim == t.embed_dim == 3 * t.patch_size ** 2 and t.num_heads == 1
    assert tbase.is_pixel_model(name) and not tbase.is_pixel_model("dinov2_vits14")
    with pytest.raises(ValueError, match="pixel<P>"):
        tvit.make_config("bogus")


@pytest.mark.parametrize("name,size", [("pixel8", 32), ("pixel14", 28)])
@pytest.mark.parametrize("facet", ["token", "query", "value"])
def test_pixel_descriptors_match_jax_with_weights_carried(name, size, facet):
    """extract_descriptors of JAX's init_pixel_params against the port's
    forward of the same weights (models/convert.py: the head-major qkv of one
    head of width 192 or 588), f32: the tokens (the raw patches) within
    1e-6; the query and value projections, sums of 588 products of O(1)
    normed values in another order, within 2e-6 (1.07e-6 found)."""
    jcfg, params, net = _carried(name)
    img = RNG.random((2, size, size, 3)).astype(np.float32)
    ref = np.asarray(jext.extract_descriptors(params, jcfg, jnp.asarray(img), layer=0,
                                              facet=facet, bin=False,
                                              compute_dtype=jnp.float32))
    with torch.no_grad():
        out = text.extract_descriptors(net, torch.from_numpy(img), layer=0, facet=facet,
                                       use_kernels=True).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6 if facet == "token" else 2e-6)


def test_port_init_gives_the_raw_patches():
    """The port's own init_pixel_params (its block drawn from a seeded
    generator): descriptors are the raw patches within 1e-4, as
    tests/test_baselines.py asks of JAX's; the layout as JAX's (identity
    embedding, zero bias and pos embed, LayerScale 1e-8)."""
    cfg = tbase.pixel_config("pixel8")
    net = tbase.init_pixel_params(cfg, torch.Generator().manual_seed(5), device="cpu").eval()
    img = torch.from_numpy(RNG.random((1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        desc = text.extract_descriptors(net, img, layer=0, facet="token", bin=False)[0, 0]
    patch = img[0, :8, :8, :].reshape(-1)
    torch.testing.assert_close(desc[0], patch, rtol=0, atol=1e-4)
    _, params, carried = _carried("pixel8")
    sd, ref = net.state_dict(), carried.state_dict()
    for k in ("patch_embed.proj.weight", "patch_embed.proj.bias", "pos_embed",
              "blocks.0.ls1.gamma", "blocks.0.ls2.gamma"):
        assert torch.equal(sd[k], ref[k]), k


def test_build_model_builds_pixel_models():
    """harness/benchmark.build_model gives a pixel config the pixel weights
    (JAX's build_model does the same), its blocks in bf16."""
    net, model = tbench.build_model(TVSConfig(model_name="pixel14", layer=0), device="cpu")
    want = dataclasses.replace(tbase.pixel_config("pixel14"), gelu_approx=True)   # create's
    assert model.vit == want and net.compute_dtype == torch.bfloat16
    assert torch.equal(net.pos_embed, torch.zeros_like(net.pos_embed))
    assert model.mean == (0.5, 0.5, 0.5)             # not a dino model: the half mean


def test_pixel8_episode_first_twists_match_jax():
    """The pixel8 episode of tests/test_baselines.py, 10 steps, JAX's weights
    carried across and its pair scores injected: every applied twist within
    1e-4 and the poses within 1e-4 (f32; the renders and descriptors of the
    two packages differ in the last bits)."""
    steps = 10
    _, params, _ = _carried("pixel8")
    jmodel = jpipe.ServoModel.create(JVSConfig(**EPISODE_CFG), compute_dtype=jnp.float32)
    tmodel = tpipe.ServoModel.create(TVSConfig(**EPISODE_CFG), compute_dtype=torch.float32,
                                     device="cpu")
    net = tmodel.load_vit(from_jax_params(params))
    tex = make_synthetic_poster(256, seed=3)
    jscene, tscene = JScene.create(tex), TScene.create(tex, device="cpu")
    jrgb, _ = jobserve(jscene, jmodel.camera, jnp.asarray(GOAL_POS), jnp.asarray(GOAL_QUAT))
    jgoal = jpipe.goal_descriptors(params, jmodel, jrgb)
    tgoal = tpipe.goal_descriptors(net, tmodel, np.array(jrgb))
    start = GOAL_POS + np.asarray([0.10, -0.08, 0.15], np.float32)
    key = jax.random.PRNGKey(0)
    jres = jax.jit(lambda sp, sq, k: jroll.rollout_episode(
        params, jmodel, jscene, jgoal, sp, sq, k, num_steps=steps))(
        jnp.asarray(start), jnp.asarray(GOAL_QUAT), key)
    gh, gw = tmodel.grid()
    tres = troll.rollout_episode(net, tmodel, tscene, tgoal, start, GOAL_QUAT,
                                 scores=rollout_scores(key, steps, gh * gw), num_steps=steps)
    np.testing.assert_allclose(tres.applied_twist_history.numpy(),
                               np.asarray(jres.applied_twist_history), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tres.position_history.numpy(),
                               np.asarray(jres.position_history), rtol=0, atol=1e-4)


@pytest.mark.parametrize("hd", [48, 192, 588])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_attention_matches_the_pallas_kernel(hd, dtype):
    """mha_attention_plain (the any-width kernel's reference on the card)
    against vitvs_tpu's Pallas kernel in interpret mode, (2, 37, 1, hd):
    f32 within 2e-6 (f32 sums over up to 588 products in another order),
    bf16 within 1.6e-2 (the Pallas kernel scales Q by hd^-0.5 in bf16 first,
    inexact at these widths: two bf16 ulps of outputs below 2)."""
    q, k, v = (RNG.standard_normal((2, 37, 1, hd)).astype(np.float32) for _ in range(3))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(jattention(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                interpret=True).astype(jnp.float32))
    out = attention.mha_attention_plain(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                               atol=2e-6 if dtype == "float32" else 1.6e-2)


@pytest.fixture
def launches(monkeypatch):
    """Route meta tensors as if they lay on a card: the device check passes,
    and each launch is recorded (entry point, the arguments after B, T, H)
    instead of reaching the kernel library, which the test may not touch."""
    seen = []

    def check(q, k, v, dtype=torch.bfloat16, head_dim=attention.HEAD_DIM):
        attention._check_layout(q, k, v, dtype, head_dim)

    def launch(entry, q, k, v, *extra):
        seen.append((entry, extra))
        return torch.empty_like(q)

    def refuse():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(attention, "_check", check)
    monkeypatch.setattr(attention, "_launch", launch)
    monkeypatch.setattr(_build, "library", refuse)
    return seen


def _meta(hd, dtype, heads=1):
    return [torch.empty((2, 37, heads, hd), dtype=dtype, device="meta") for _ in range(3)]


@pytest.mark.parametrize("hd", [1, 48, 63, 192, 588, 768, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_other_head_widths_go_to_the_any_width_kernel(launches, hd, dtype):
    """mha_attention (and mha_attention_f32 for f32) send a head width other
    than 64 to the any-width kernel, with its width and the f32 scale of the
    true width, counted on its own counter; 64 stays on the exact kernels."""
    counter = attention.mha_attention_hd if dtype == torch.bfloat16 else attention.mha_attention_hd_f32
    entry = attention.HD_ENTRIES[dtype]
    before = counter.launches
    assert attention.exact_entry(*_meta(hd, dtype)) == entry
    calls = [attention.mha_attention]
    if dtype == torch.float32:
        calls.append(attention.mha_attention_f32)
    for fn in calls:
        out = fn(*_meta(hd, dtype))
        assert out.shape == (2, 37, 1, hd) and out.dtype == dtype
    assert launches == [(entry, (hd, hd ** -0.5))] * len(calls)
    assert counter.launches == before + len(calls)
    assert attention.exact_entry(*_meta(64, dtype, 3)) == attention.EXACT_ENTRIES[dtype]


def test_any_width_kernel_takes_the_unaligned_qkv_split(launches):
    """pixel14's k and v, slices of one (3, B, T, 1, 588) bf16 tensor, start
    8 bytes past a 16-byte boundary: the any-width kernel (element loads)
    takes them, the 64-wide kernels' 16-byte rule does not apply."""
    q, k, v = torch.zeros((3, 1, 485, 1, 588), dtype=torch.bfloat16).unbind(0)
    assert k.data_ptr() % 16 == 8
    attention._check_layout(q, k, v, torch.bfloat16, head_dim=None)


@pytest.mark.parametrize("hd", [0, 1025])
def test_any_width_kernel_refuses_widths_outside_its_range(launches, hd):
    with pytest.raises(ValueError, match="1 <= d <= 1024"):
        attention.mha_attention(*_meta(hd, torch.bfloat16))
    assert launches == []


@pytest.mark.parametrize("hd", [48, 588])
def test_no_max_and_int8_kernels_refuse_other_widths(launches, hd):
    """The no-max kernel (fast=True) and the int8 kernel read 64-wide heads
    only: a pixel model's width raises ValueError naming 64 before any
    launch (the JAX package builds neither for a pixel model)."""
    with pytest.raises(ValueError, match=r"\(B, T, h, 64\)"):
        attention.mha_attention(*_meta(hd, torch.bfloat16), fast=True)
    q = torch.zeros((1, 9, hd), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="64"):
        attn_int8._check_layout(q, q, q, 1)
    assert launches == []


def test_cli_runs_a_pixel_model_on_a_mesh_with_the_live_channel(tmp_path, capsys):
    """The command line takes a pixel model where the JAX one does (the
    config's model_name), with --mesh on the CPU and --live: 2 episodes of
    4 steps write the reference's npz and one live snapshot."""
    from vitvs_tpu_torch.io_bridge import cli

    cfg = tmp_path / "pixel.yaml"
    cfg.write_text("u_max: 128\nv_max: 128\nf_x: 100.5\nf_y: 100.5\nnum_pairs: 12\n"
                   "num_circles: 1\ndino_input_size: 56\nlayer: 0\npinv_mode: dls\n"
                   "model_name: pixel8\n")
    argv = ["--method", "dino", "--config", str(cfg), "--poster", "synthetic",
            "--num-samples", "2", "--num-steps", "4", "--chunk", "2", "--device", "cpu",
            "--no-rotation-search", "--mesh", "--live", str(tmp_path / "live"),
            "--out", str(tmp_path)]
    assert cli.main(argv) == 0
    path = tmp_path / "results_pixel_n2_steps4_poster-synthetic_dino_no_rot_standard.npz"
    assert len(np.load(path, allow_pickle=True)["convergence_flags"]) == 2
    assert [p.name for p in (tmp_path / "live").glob("ep*.png")] == ["ep0000_step00004.png"]
    assert "convergence:" in capsys.readouterr().out
