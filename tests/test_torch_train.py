"""Port parity: descriptor training (vitvs_tpu_torch/train) against
vitvs_tpu/train on the CPU.

The losses and their gradients are held against ``jax.jit(jax.value_and_grad)``
of the reference on the same parameters (``from_jax_params``) and the same
numpy batch, on a tiny ViT (2 blocks, 96 wide, 112 px) in f32 and bf16, and
once at full ViT-S/14 @ 308 width on the trained ``artifacts/ckpt_real308``;
AdamW and its warm-up cosine schedule against optax; the geometric
correspondence against the jitted reference on the servo sampler's poses;
the samplers by their distributions; the weight file round trip; and the
trainer's entry point for 3 steps.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitvs_tpu.harness.pipeline import ServoModel as JModel
from vitvs_tpu.io_bridge.config import VSConfig as JCfg
from vitvs_tpu.models import vit as jvit
from vitvs_tpu.train import finetune as jft
from vitvs_tpu_torch.harness.pipeline import ServoModel
from vitvs_tpu_torch.io_bridge.config import VSConfig
from vitvs_tpu_torch.models import vit as tvit
from vitvs_tpu_torch.models.convert import (TRAINED_S518, from_jax_params, load_exported,
                                            save_exported)
from vitvs_tpu_torch.ops import attention, attn_int8, matcher
from vitvs_tpu_torch.sim.scene import Scene, make_synthetic_poster
from vitvs_tpu_torch.train import finetune as tft

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOAL_POS = torch.tensor([0.0, 0.0, 0.61])
GOAL_QUAT = torch.tensor([0.0, 0.7071068, 0.0, 0.7071068])
# the tiny model of the reference's own training tests
TINY_CFG = dict(u_max=128, v_max=128, f_x=100.5, f_y=100.5, dino_input_size=112,
                model_name="tiny", layer=1, use_feature_binning=False)
TINY_VIT = dict(patch_size=14, embed_dim=64, depth=2, num_heads=2, pos_grid=16, stride=14,
                model_name="tiny")
# the parity model: 2 blocks, 96 wide, 112 px (an 8 x 8 grid)
PARITY_VIT = dict(patch_size=14, embed_dim=96, depth=2, num_heads=3, pos_grid=5, stride=14,
                  model_name="tiny")
# the loss and gradient tolerances: (loss, relative; every gradient, of its
# tensor's max abs).  bf16: the two packages round at different points
TOL = {"float32": (1e-6, 1e-5), "bfloat16": (1e-3, 2e-2)}


@pytest.fixture
def one_intra_op_thread():
    """Tiny shapes run thousands of small ops: one intra-op thread each, as
    the suite's parallel workers share the machine's cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(vit_kw=TINY_VIT, cfg_kw=TINY_CFG, dtype=torch.float32, seed=0):
    """The port's model, a seeded f32 ViT and a synthetic-poster scene."""
    vcfg = tvit.ViTConfig(**vit_kw)
    model = ServoModel(vit=vcfg, cfg=VSConfig(**cfg_kw), compute_dtype=dtype, device="cpu")
    net = tvit.init_vit(vcfg, torch.Generator().manual_seed(seed), device="cpu")
    scene = Scene.create(make_synthetic_poster(256, seed=3), device="cpu")
    return net, model, scene


# ---------------------------------------------------------------------------
# geometric supervision
# ---------------------------------------------------------------------------


def test_identity_correspondence():
    """Same pose -> every on-poster patch maps to itself."""
    _, model, scene = _tiny()
    idx, valid = tft.geometric_correspondences(model, scene, GOAL_POS, GOAL_QUAT,
                                               GOAL_POS, GOAL_QUAT)
    t = model.grid()[0] * model.grid()[1]
    assert idx.shape == (t,)
    v = valid.numpy()
    assert v.sum() > t // 2
    np.testing.assert_array_equal(idx.numpy()[v], np.arange(t)[v])


def test_translated_correspondence_shifts():
    """Camera shifted +x world by one patch footprint -> rows shift by 1."""
    _, model, scene = _tiny()
    gh, gw = model.grid()
    dx = 16 * 0.605 / 100.5
    idx, valid = tft.geometric_correspondences(
        model, scene, GOAL_POS, GOAL_QUAT, GOAL_POS + torch.tensor([dx, 0.0, 0.0]), GOAL_QUAT)
    v = valid.numpy()
    src = np.arange(gh * gw)[v]
    dst = idx.numpy()[v]
    assert np.median(dst // gw - src // gw) == 1.0


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------


def test_pair_batch_shapes(one_intra_op_thread):
    _, model, scene = _tiny()
    batch = tft.make_pair_batch(model, scene, torch.Generator().manual_seed(0), batch=2)
    t = model.grid()[0] * model.grid()[1]
    s = model.cfg.dino_input_size
    assert batch["img_a"].shape == (2, s, s, 3) and batch["img_b"].shape == (2, s, s, 3)
    assert batch["idx"].shape == (2, t) and batch["valid"].shape == (2, t)
    assert bool(batch["valid"].sum() > 0) and not batch["img_a"].requires_grad


def test_servo_pair_batch_shapes_and_views(one_intra_op_thread):
    """The goal image is the clean goal view; every view of the batch is one
    render of its drawn pose, on its own perturbed texture when drawn so."""
    from vitvs_tpu_torch.harness.pipeline import preprocess
    from vitvs_tpu_torch.sim.env import observe

    _, model, scene = _tiny()
    goal, batch = tft.make_servo_pair_batch(model, scene, torch.Generator().manual_seed(5), 4)
    poses = tft.draw_servo_poses(torch.Generator().manual_seed(5), 4)
    t, s = model.grid()[0] * model.grid()[1], model.cfg.dino_input_size
    assert goal.shape == (s, s, 3) and batch["img_b"].shape == (4, s, s, 3)
    for k in ("idx_ab", "valid_ab", "idx_ba", "valid_ba"):
        assert batch[k].shape == (4, t)
    ref_goal = preprocess(model, observe(scene, model.camera, GOAL_POS, GOAL_QUAT)[0])
    torch.testing.assert_close(goal, ref_goal, rtol=0, atol=0)
    for b in range(4):
        sc = scene
        if poses.perturbed[b]:
            sc = scene.with_texture(tft._perturbed_textures(scene, [poses.seeds[b]])[0])
        rgb = observe(sc, model.camera, poses.position[b], poses.quat[b])[0]
        torch.testing.assert_close(batch["img_b"][b], preprocess(model, rgb), rtol=0, atol=2e-6)


def test_servo_sampler_distribution():
    """400 draws: positions inside the box around the goal with z at least
    min_z, spins within +-135 deg and spread over them, the focal point's
    look-at (the optical axis points down at the poster), and a perturbed
    share of 0.5 +- 0.1."""
    from vitvs_tpu_torch.core import se3

    p = tft.draw_servo_poses(torch.Generator().manual_seed(2), 400)
    off = p.position - GOAL_POS
    assert bool((off[:, :2].abs() <= 0.6).all()) and bool((off[:, 2].abs() <= 0.15).all())
    assert bool((p.position[:, 2] >= 0.12).all())
    assert float(off[:, :2].abs().max()) > 0.55
    lim = np.radians(135.0)
    assert bool((p.spin.abs() <= lim).all()) and float(p.spin.abs().max()) > 0.9 * lim
    assert abs(float(p.spin.mean())) < 0.25
    fwd = se3.quat_rotate(p.quat, torch.tensor([1.0, 0.0, 0.0]).expand(400, 3))
    # the optical axis hits the plane z = 0.01 within the focal square
    t = (0.01 - p.position[:, 2]) / fwd[:, 2]
    hit = p.position + t[:, None] * fwd
    assert bool((t > 0).all()) and float(hit[:, :2].abs().max()) <= 0.32 + 1e-4
    assert 0.4 <= float(np.mean(p.perturbed)) <= 0.6
    none = tft.draw_servo_poses(torch.Generator().manual_seed(2), 50, perturb_prob=0.0)
    assert not any(none.perturbed)
    # min_z binds when the box reaches below it
    low = tft.draw_servo_poses(torch.Generator().manual_seed(3), 200, min_z=0.7)
    z = low.position[:, 2]
    assert bool((z >= 0.7).all()) and 0 < int((z == 0.7).sum()) < 200


def test_pair_sampler_distribution():
    """make_pair_batch's poses: within +-0.08 m of the goal and +-10 deg
    about the optical axis; the same generator gives the same batch."""
    _, model, scene = _tiny()
    a = tft.make_pair_batch(model, scene, torch.Generator().manual_seed(9), 3, perturb=False)
    b = tft.make_pair_batch(model, scene, torch.Generator().manual_seed(9), 3, perturb=False)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    # small offsets keep most of the goal view's patches matched
    assert float(a["valid"].float().mean()) > 0.5


# ---------------------------------------------------------------------------
# losses and gradients against jax.jit(jax.value_and_grad)
# ---------------------------------------------------------------------------


def _parity_params(jcfg):
    """Seeded JAX parameters with LayerScale near 1 and nonzero biases, so
    that every term of the blocks carries gradient."""
    params = jax.tree.map(np.asarray, jvit.init_vit(jcfg, jax.random.PRNGKey(3)))
    rs = np.random.default_rng(5)
    for name in ("ls1", "ls2"):
        params["blocks"][name] = rs.uniform(0.5, 1.5, params["blocks"][name].shape).astype(np.float32)
    for name in ("qkv_bias", "proj_bias", "fc1_bias", "fc2_bias", "norm1_bias"):
        params["blocks"][name] = 0.1 * rs.standard_normal(params["blocks"][name].shape).astype(np.float32)
    return params


def _parity_models(dtype_name, vit_kw=PARITY_VIT, cfg_kw=None, gelu_approx=True):
    cfg_kw = cfg_kw or dict(TINY_CFG)
    jcfg = jvit.ViTConfig(**vit_kw, gelu_approx=gelu_approx)
    tcfg = tvit.ViTConfig(**vit_kw, gelu_approx=gelu_approx)
    jm = JModel(vit=jcfg, cfg=JCfg(**cfg_kw), compute_dtype=getattr(jnp, dtype_name))
    tm = ServoModel(vit=tcfg, cfg=VSConfig(**cfg_kw), compute_dtype=getattr(torch, dtype_name),
                    device="cpu")
    return jm, tm


def _port_net(tcfg, params) -> tvit.ViT:
    net = tvit.ViT(tcfg)
    net.load_state_dict(from_jax_params(params))
    return net


def _servo_batch_np(rs, n, s, t):
    return (rs.standard_normal((s, s, 3)).astype(np.float32),
            {"img_b": rs.standard_normal((n, s, s, 3)).astype(np.float32),
             "idx_ab": rs.integers(0, t, (n, t)).astype(np.int32),
             "valid_ab": rs.random((n, t)) < 0.7,
             "idx_ba": rs.integers(0, t, (n, t)).astype(np.int32),
             "valid_ba": rs.random((n, t)) < 0.6})


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)).to(torch.int64 if k.startswith("idx") else None)
            for k, v in batch.items()}


# the gradients the reference forms as sums over every token of bf16
# cotangents (the blocks' Linear biases and LayerScale gammas): XLA's CPU
# backend reduces them in bf16, which puts its bf16 gradients of them up to
# 5.9e-2 of max abs from its own f32 ones, where the port's (f32 sums) stay
# within 1.3e-2 (tiny model, bf16)
BF16_REDUCED = (".attn.qkv.bias", ".attn.proj.bias", ".mlp.fc1.bias", ".mlp.fc2.bias",
                ".ls1.gamma", ".ls2.gamma")


def _grad_err(mine: torch.Tensor, want: torch.Tensor) -> float:
    return float((mine - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def _hold_grads(jgrads, net, tol, f32_grads=None):
    """Every gradient of ``net`` within ``tol`` of its tensor's max abs of
    the reference's ``jgrads``; with ``f32_grads`` (the reference's f32
    gradients, for a bf16 run) the BF16_REDUCED ones are held to those
    instead."""
    want = from_jax_params(jax.tree.map(np.asarray, jgrads))
    truth = None if f32_grads is None else from_jax_params(jax.tree.map(np.asarray, f32_grads))
    got = dict(net.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        mine = got[name].grad
        if name.startswith("norm."):
            # the final norm is off the facet path: autograd never reaches it,
            # and the reference's gradient there is zero
            assert mine is None and not torch.any(g), name
            continue
        assert mine is not None and mine.dtype == torch.float32, name
        if truth is not None and name.endswith(BF16_REDUCED):
            g = truth[name]
        err = _grad_err(mine, g)
        assert err <= tol, (name, err)


def _reference_value_and_grad(loss_fn, jm, params):
    """jax.jit(jax.value_and_grad) of ``loss_fn(params, model)`` for ``jm``,
    and for a bf16 ``jm`` also the f32 gradients."""
    ref = jax.jit(jax.value_and_grad(lambda p: loss_fn(p, jm)))(params)
    f32 = None
    if jm.compute_dtype != jnp.float32:
        jm32 = dataclasses.replace(jm, compute_dtype=jnp.float32)
        f32 = jax.jit(jax.grad(lambda p: loss_fn(p, jm32)))(params)
    return ref, f32


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_servo_batch_loss_and_grads_match_jitted_reference(dtype_name, one_intra_op_thread):
    """The symmetric servo InfoNCE of a goal and 3 views, and its gradient
    for every parameter, against jax.jit(jax.value_and_grad) of the
    reference on the same f32 parameters and numpy batch."""
    jm, tm = _parity_models(dtype_name)
    params = _parity_params(jm.vit)
    t = tm.grid()[0] * tm.grid()[1]
    goal, batch = _servo_batch_np(np.random.default_rng(7), 3, 112, t)
    (ref_loss, ref_grads), f32_grads = _reference_value_and_grad(
        lambda p, m: jft._servo_batch_loss(p, m, jnp.asarray(goal),
                                           jax.tree.map(jnp.asarray, batch)), jm, params)
    net = _port_net(tm.vit, params)
    loss = tft._servo_batch_loss(net, tm, torch.from_numpy(goal), _torch_batch(batch))
    loss.backward()
    loss_tol, grad_tol = TOL[dtype_name]
    assert abs(loss.item() - float(ref_loss)) <= loss_tol * abs(float(ref_loss))
    _hold_grads(ref_grads, net, grad_tol, f32_grads)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_pair_batch_loss_and_grads_match_jitted_reference(dtype_name, one_intra_op_thread):
    """_batch_loss (pairs A -> B, info_nce_loss) and its gradients against
    the jitted reference."""
    jm, tm = _parity_models(dtype_name)
    params = _parity_params(jm.vit)
    t = tm.grid()[0] * tm.grid()[1]
    rs = np.random.default_rng(8)
    batch = {"img_a": rs.standard_normal((2, 112, 112, 3)).astype(np.float32),
             "img_b": rs.standard_normal((2, 112, 112, 3)).astype(np.float32),
             "idx": rs.integers(0, t, (2, t)).astype(np.int32),
             "valid": rs.random((2, t)) < 0.8}
    (ref_loss, ref_grads), f32_grads = _reference_value_and_grad(
        lambda p, m: jft._batch_loss(p, m, jax.tree.map(jnp.asarray, batch)), jm, params)
    net = _port_net(tm.vit, params)
    loss = tft._batch_loss(net, tm, _torch_batch(batch))
    loss.backward()
    loss_tol, grad_tol = TOL[dtype_name]
    assert abs(loss.item() - float(ref_loss)) <= loss_tol * abs(float(ref_loss))
    _hold_grads(ref_grads, net, grad_tol, f32_grads)


@pytest.mark.parametrize("score,pool", [("relu", 1), ("sqrelu", 1), ("relu", 2), ("sqrelu", 2)])
def test_servo_loss_and_grads_with_scores_match_jitted_reference(score, pool,
                                                                 one_intra_op_thread):
    """Co-training the relu / sqrelu scores (train_servo --attn-score, with
    --kv-pool 2 on the 8 x 8 grid): the servo InfoNCE and every gradient
    against jax.jit(jax.value_and_grad) of the reference, f32, within the
    softmax step's tolerances (loss 1e-6 relative, gradients 1e-5 of max
    abs).  sqrelu with 2 x 2 pooling is worse conditioned (rows with no
    positive logit sit on the denominator's floor, and the squares amplify
    the rest): there the reference's f32 gradients lie up to 7.2e-5 of max
    abs from the same function in f64 (the port's in f64), the port's f32
    ones 2.6e-5; so the port is held within 3e-5 of its f64 gradients and
    within 1e-4 of the reference's."""
    jm, tm = _parity_models("float32", vit_kw=dict(PARITY_VIT, attn_score=score, kv_pool=pool))
    params = _parity_params(jm.vit)
    t = tm.grid()[0] * tm.grid()[1]
    goal, batch = _servo_batch_np(np.random.default_rng(9), 2, 112, t)
    (ref_loss, ref_grads), _ = _reference_value_and_grad(
        lambda p, m: jft._servo_batch_loss(p, m, jnp.asarray(goal),
                                           jax.tree.map(jnp.asarray, batch)), jm, params)
    net = _port_net(tm.vit, params)
    loss = tft._servo_batch_loss(net, tm, torch.from_numpy(goal), _torch_batch(batch))
    loss.backward()
    loss_tol, grad_tol = TOL["float32"]
    assert abs(loss.item() - float(ref_loss)) <= loss_tol * abs(float(ref_loss))
    if (score, pool) != ("sqrelu", 2):
        _hold_grads(ref_grads, net, grad_tol)
        return
    _hold_grads(ref_grads, net, 1e-4)
    net64 = _port_net(tm.vit, params).double()
    batch64 = {k: v.double() if v.is_floating_point() else v
               for k, v in _torch_batch(batch).items()}
    tft._servo_batch_loss(net64, dataclasses.replace(tm, compute_dtype=torch.float64),
                          torch.from_numpy(goal).double(), batch64).backward()
    for (name, p), p64 in zip(net.named_parameters(), net64.parameters()):
        if name.startswith("norm."):           # the final norm: off the facet path
            assert p.grad is None and p64.grad is None, name
            continue
        assert _grad_err(p.grad, p64.grad.float()) <= 3e-5, name


def test_info_nce_loss_and_grads_match_jitted_reference():
    """info_nce_loss alone, its gradient with respect to both descriptor
    sets, and the port's batched form against one pair at a time."""
    rs = np.random.default_rng(9)
    a, b = (rs.standard_normal((3, 40, 24)).astype(np.float32) for _ in range(2))
    idx = rs.integers(0, 40, (3, 40)).astype(np.int32)
    valid = rs.random((3, 40)) < 0.5
    valid[2] = False                                     # no valid patch: loss 0
    ref = [jax.jit(jax.value_and_grad(jft.info_nce_loss, argnums=(0, 1)))(
        a[i], b[i], idx[i], valid[i]) for i in range(3)]
    ta, tb = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b).requires_grad_()
    loss = tft.info_nce_loss(ta, tb, torch.from_numpy(idx).long(), torch.from_numpy(valid))
    loss.sum().backward()
    loss = loss.detach()
    for i, (rl, (ga, gb)) in enumerate(ref):
        assert abs(float(loss[i]) - float(rl)) <= 1e-6 * max(abs(float(rl)), 1.0)
        np.testing.assert_allclose(ta.grad[i].numpy(), np.asarray(ga), atol=1e-6)
        np.testing.assert_allclose(tb.grad[i].numpy(), np.asarray(gb), atol=1e-6)
    assert float(loss[2]) == 0.0


def test_servo_loss_at_full_vits14_width_on_trained_weights(one_intra_op_thread):
    """Full ViT-S/14 @ 308 on the trained ckpt_real308 (orbax, read through
    the JAX package), f32, the goal and one view: the loss and every
    gradient against the jitted reference (the tiny f32 clauses)."""
    from vitvs_tpu.models.convert import load_params

    params = jax.tree.map(np.asarray, load_params(os.path.join(REPO, "artifacts", "ckpt_real308")))
    cfg_kw = dict(dino_input_size=308)
    jm = JModel.create(JCfg(**cfg_kw), compute_dtype=jnp.float32)
    tm = ServoModel.create(VSConfig(**cfg_kw), compute_dtype=torch.float32, device="cpu")
    assert jm.vit.gelu_approx and tm.vit.gelu_approx
    t = tm.grid()[0] * tm.grid()[1]
    rs = np.random.default_rng(10)
    goal, batch = _servo_batch_np(rs, 1, 308, t)
    # images in the preprocessed range
    goal, batch["img_b"] = goal * 0.5, batch["img_b"] * 0.5
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: jft._servo_batch_loss(p, jm, jnp.asarray(goal),
                                        jax.tree.map(jnp.asarray, batch))))(params)
    net = _port_net(tm.vit, params)
    torch.set_num_threads(4)
    loss = tft._servo_batch_loss(net, tm, torch.from_numpy(goal), _torch_batch(batch))
    loss.backward()
    loss_tol, grad_tol = TOL["float32"]
    assert abs(loss.item() - float(ref_loss)) <= loss_tol * abs(float(ref_loss))
    _hold_grads(ref_grads, net, grad_tol)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def test_adamw_and_schedule_match_optax():
    """150 updates (warm-up 100) of AdamW with the warm-up cosine schedule
    from the same parameters and the same gradient sequence as
    optax.adamw(optax.warmup_cosine_decay_schedule(...), weight_decay=1e-4):
    parameters within 1e-6 relative, and the first update changes nothing
    (optax evaluates the schedule at the count before the update)."""
    import optax

    steps, warmup, lr = 300, 100, 3e-3
    rs = np.random.default_rng(12)
    p0 = {"w": rs.standard_normal((6, 5)).astype(np.float32),
          "b": rs.standard_normal((5,)).astype(np.float32)}
    grads = [{k: rs.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(150)]
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps, warmup + 1), lr * 0.05)
    opt = optax.adamw(sched, weight_decay=1e-4)
    jp = jax.tree.map(jnp.asarray, p0)
    jstate = opt.init(jp)
    upd = jax.jit(lambda g, s, p: opt.update(g, s, p))
    net = torch.nn.Module()
    for k, v in p0.items():
        net.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    schedule = tft.warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps, warmup + 1), lr * 0.05)
    state = tft.init_train_state(net, schedule)
    for i, g in enumerate(grads):
        u, jstate = upd(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, u)
        state.optimizer.zero_grad()
        for k, v in g.items():
            getattr(net, k).grad = torch.from_numpy(v)
        state.optimizer.step()
        state.scheduler.step()
        if i == 0:
            for k, v in p0.items():
                np.testing.assert_array_equal(getattr(net, k).detach().numpy(), v)
        if i in (0, 99, 100, 149):
            for k in p0:
                np.testing.assert_allclose(getattr(net, k).detach().numpy(), np.asarray(jp[k]),
                                           rtol=1e-6, atol=1e-6 * float(np.abs(p0[k]).max()))
    for c in (0, 1, 50, 100, 101, 200, 299, 300, 400):
        assert abs(schedule(c) - float(sched(c))) <= 1e-6 * lr


def test_apply_gradients_decays_unreached_parameters():
    """A parameter the loss does not reach still decays, as optax's adamw
    decays every leaf."""
    net = torch.nn.Linear(3, 2)
    net.register_parameter("spare", torch.nn.Parameter(torch.ones(4)))
    state = tft.init_train_state(net, 1e-2)
    x = torch.ones(1, 3)
    for _ in range(3):
        state = tft.apply_gradients(state, net(x).sum())
    assert state.step == 3
    np.testing.assert_allclose(net.spare.detach().numpy(), np.full(4, (1 - 1e-2 * 1e-4) ** 3),
                               rtol=1e-7)


# ---------------------------------------------------------------------------
# the reference's own training tests
# ---------------------------------------------------------------------------


def test_matching_quality_serves_the_quantized_path(one_intra_op_thread):
    """matching_quality runs the serving path: with a quantized model the
    int8 extraction and the int8 match, from the f32 net or a QuantViT."""
    from vitvs_tpu_torch.harness.pipeline import quantized_vit

    net, model, scene = _tiny()
    f0, a0 = tft.matching_quality(net, model, scene, torch.Generator().manual_seed(0),
                                  num_views=2)
    qmodel = dataclasses.replace(model, quantized=True)
    f1, a1 = tft.matching_quality(net, qmodel, scene, torch.Generator().manual_seed(0),
                                  num_views=2)
    f2, a2 = tft.matching_quality(quantized_vit(net, qmodel), qmodel, scene,
                                  torch.Generator().manual_seed(0), num_views=2)
    for v in (f0, a0, f1, a1):
        assert np.isfinite(v) and 0.0 <= v <= 1.0
    assert abs(f1 - f0) < 0.5 and (f1, a1) == (f2, a2)


def test_matching_quality_source_quantized_bins(one_intra_op_thread):
    """A binned quantized model takes source-quantized bins."""
    cfg_kw = dict(TINY_CFG, use_feature_binning=True)
    net, model, scene = _tiny(cfg_kw=cfg_kw)
    qmodel = dataclasses.replace(model, quantized=True)
    assert qmodel.source_quantized_bins
    f, a = tft.matching_quality(net, qmodel, scene, torch.Generator().manual_seed(1),
                                num_views=2)
    assert np.isfinite(f) and 0.0 <= f <= 1.0 and 0.0 <= a <= 1.0


def test_training_reduces_loss(one_intra_op_thread):
    """A randomly initialized tiny ViT learns matchable descriptors: 60 steps
    of AdamW at 3e-3, the last 5 losses below 0.85 x the first 5."""
    net, model, scene = _tiny()
    state, losses = tft.train_descriptor_model(net, model, scene, steps=60, batch=4,
                                               learning_rate=3e-3, seed=1)
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < 0.85 * first, (first, last)
    assert state.step == 60 and len(losses) == 60


def test_remat_blocks_gradients_match():
    """ViTConfig.remat_blocks recomputes each block in the backward pass and
    must not change the gradients, f32 and in the bf16 training forward."""
    cfg = tvit.ViTConfig(patch_size=14, embed_dim=64, depth=3, num_heads=4, pos_grid=8,
                         stride=14, model_name="tiny")
    imgs = torch.from_numpy(np.random.default_rng(0).random((2, 56, 56, 3)).astype(np.float32))
    for dtype in (None, torch.bfloat16):
        grads = []
        for remat in (False, True):
            net = tvit.init_vit(dataclasses.replace(cfg, remat_blocks=remat),
                                torch.Generator().manual_seed(0), device="cpu", layerscale=0.5)
            f = tvit.vit_features(net, imgs, layer=2, use_kernels=False, compute_dtype=dtype)
            (f.float() ** 2).sum().backward()
            # the final norm is off the facet path: no gradient either way
            grads.append({n: p.grad.clone() for n, p in net.named_parameters()
                          if not n.startswith("norm.")})
            assert net.norm.weight.grad is None and net.norm.bias.grad is None
        for n in grads[0]:
            np.testing.assert_allclose(grads[1][n].numpy(), grads[0][n].numpy(), atol=1e-6,
                                       err_msg=n)


def test_training_forward_keeps_f32_weights_and_serving_forward_unchanged():
    """The training forward leaves the parameters f32 and gives them
    gradients; without compute_dtype the forward equals the one of a net
    whose blocks were cast (the serving form)."""
    net, model, _ = _tiny(dtype=torch.bfloat16)
    imgs = torch.from_numpy(np.random.default_rng(1).random((1, 112, 112, 3)).astype(np.float32))
    f = tvit.vit_features(net, imgs, layer=1, use_kernels=False, compute_dtype=torch.bfloat16)
    assert f.dtype == torch.bfloat16
    f.float().sum().backward()
    for n, p in net.named_parameters():
        if n.startswith("norm."):            # the final norm: off the facet path
            assert p.dtype == torch.float32 and p.grad is None, n
            continue
        assert p.dtype == torch.float32 and p.grad is not None and p.grad.dtype == torch.float32, n
    serve = model.load_vit(net.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(tvit.vit_features(serve, imgs, layer=1, use_kernels=False),
                                   f.detach(), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the hand kernels refuse autograd
# ---------------------------------------------------------------------------


def _grad_inputs(shape, dtype=torch.float32):
    return [torch.randn(shape, dtype=dtype, requires_grad=True) for _ in range(3)]


@pytest.mark.parametrize("entry", ["mha_attention", "mha_attention_f32", "mha_attention_fast",
                                   "fused_int8_attention", "dual_argmax_cosine",
                                   "dual_argmax_cosine_bf16"])
def test_kernel_entries_refuse_inputs_that_require_grad(entry):
    """Every hand-kernel entry raises on grad-requiring inputs while grad is
    enabled (the kernels have no backward), before any device check; under
    no_grad, and on inputs that need no grad, CPU tensors take the plain
    versions."""
    q, k, v = _grad_inputs((1, 5, 2, 64))
    a, b = torch.randn(6, 8, requires_grad=True), torch.randn(7, 8)
    calls = {"mha_attention": lambda: attention.mha_attention(q, k, v),
             "mha_attention_f32": lambda: attention.mha_attention_f32(q, k, v),
             "mha_attention_fast": lambda: attention.mha_attention_fast(q, k, v),
             "fused_int8_attention": lambda: attn_int8.fused_int8_attention(
                 q.reshape(1, 5, 128), k.reshape(1, 5, 128), v.reshape(1, 5, 128), 2),
             "dual_argmax_cosine": lambda: matcher.dual_argmax_cosine(a, b),
             "dual_argmax_cosine_bf16": lambda: matcher.dual_argmax_cosine_bf16(b, a)}
    with pytest.raises(RuntimeError, match="no backward"):
        calls[entry]()
    with torch.no_grad():
        calls[entry]()
    q, k, v, a = q.detach(), k.detach(), v.detach(), a.detach()
    calls[entry]()


def test_kernel_forward_under_grad_raises_inside_the_vit():
    """A ViT forward with kernels on and grad enabled raises instead of
    silently dropping the attention's share of the gradient."""
    net, _, _ = _tiny()
    imgs = torch.zeros(1, 112, 112, 3)
    with pytest.raises(RuntimeError, match="no backward"):
        tvit.vit_features(net, imgs, layer=1, use_kernels=True)
    with torch.no_grad():
        tvit.vit_features(net, imgs, layer=1, use_kernels=True)


# ---------------------------------------------------------------------------
# the weight file
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("blocks_dtype", ["float32", "bfloat16"])
def test_save_exported_round_trips_bit_for_bit(tmp_path, blocks_dtype):
    net, _, _ = _tiny(vit_kw=dict(TINY_VIT, model_name="custom_tiny"))
    sd = {k: v.detach() for k, v in net.state_dict().items()}
    path = tmp_path / "w.npz"
    save_exported(path, sd, net.cfg, blocks_dtype)
    got, cfg = load_exported(path)
    assert cfg == net.cfg and set(got) == set(sd)
    for k, v in sd.items():
        want = v.to(torch.bfloat16) if k.startswith("blocks.") and blocks_dtype == "bfloat16" else v
        assert got[k].dtype == want.dtype, k
        assert torch.equal(got[k], want), k


def test_shipped_weights_unchanged_and_save_exported_reproduces_them(tmp_path):
    """The shipped ckpt_real518.npz keeps its bytes (its size and its
    config) and loads as before; save_exported writes the same arrays
    from what load_exported returns."""
    assert TRAINED_S518.stat().st_size == 32_956_963
    sd, cfg = load_exported(TRAINED_S518)
    path = tmp_path / "again.npz"
    save_exported(path, sd, cfg, "bfloat16", source="ckpt_real518")
    with np.load(TRAINED_S518) as a, np.load(path) as b:
        assert sorted(a.files) == sorted(b.files)
        assert json.loads(str(a["__config__"])) == json.loads(str(b["__config__"]))
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# the trainer's entry point
# ---------------------------------------------------------------------------


def test_train_servo_runs_three_steps_on_the_cpu(tmp_path, one_intra_op_thread):
    """python -m vitvs_tpu_torch.train.train_servo --device cpu: 3 steps in
    chains of 1 of ViT-S/14 up to block 1 at 56 px on the synthetic poster;
    the final weights, which load_exported and the command line's
    --checkpoint read, the trainlog, and no part checkpoint left."""
    from vitvs_tpu_torch.io_bridge.cli import load_checkpoint
    from vitvs_tpu_torch.train import train_servo

    out = tmp_path / "ckpt.npz"
    argv = ["--out", str(out), "--steps", "3", "--batch", "2", "--chain", "1", "--size", "56",
            "--poster", "synthetic", "--device", "cpu", "--warmup", "1", "--layer", "1"]
    log = train_servo.main(argv)
    assert len(log["loss"]) == 3 and all(np.isfinite(log["loss"]))
    assert not (tmp_path / "ckpt.npz.part.npz").exists()
    trainlog = json.loads((tmp_path / "ckpt.npz.trainlog.json").read_text())
    assert trainlog["loss"] == log["loss"] and len(trainlog["final_matching"]) == 2
    assert trainlog["args"]["steps"] == 3 and trainlog["args"]["poster"] == "synthetic"
    sd, cfg = load_exported(out)
    assert cfg == tvit.make_config("dinov2_vits14")
    assert all(v.dtype == torch.float32 for v in sd.values())
    net = load_checkpoint(str(out), VSConfig(dino_input_size=56, layer=1), "cpu")
    for k, v in net.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_train_servo_budget_stop_resumes_exactly(tmp_path, one_intra_op_thread):
    """A run stopped by its time budget leaves its part checkpoint; a second
    call continues from it (weights, optimizer, schedule and draws) and ends
    with the losses and weights of a run never stopped."""
    from vitvs_tpu_torch.train import train_servo

    common = ["--steps", "3", "--batch", "1", "--chain", "1", "--size", "56", "--poster",
              "synthetic", "--device", "cpu", "--warmup", "1", "--layer", "0"]
    whole = train_servo.main(["--out", str(tmp_path / "a.npz"), *common])
    part = train_servo.train(train_servo.parse_args(["--out", str(tmp_path / "b.npz"), *common]),
                             budget_s=0.0)
    assert part["done"] == 1 and not part["finished"]
    assert (tmp_path / "b.npz.part.npz").exists() and (tmp_path / "b.npz.part.json").exists()
    rest = train_servo.main(["--out", str(tmp_path / "b.npz"), *common])
    assert rest["loss"] == whole["loss"]
    a, _ = load_exported(tmp_path / "a.npz")
    b, _ = load_exported(tmp_path / "b.npz")
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_train_servo_refuses_what_it_does_not_run(tmp_path):
    from vitvs_tpu_torch.train import train_servo

    with pytest.raises(SystemExit):
        train_servo.parse_args(["--out", str(tmp_path / "x.npz"), "--attn-score", "gelu"])
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="export_port_weights"):
        train_servo.main(["--out", str(tmp_path / "x.npz"), "--resume", str(tmp_path / "orbax"),
                          "--device", "cpu", "--size", "56"])


@pytest.mark.parametrize("score", ["relu"])
def test_train_servo_cotrains_the_scores(tmp_path, score, one_intra_op_thread):
    """train_servo --attn-score relu --kv-pool 2 runs (the campaign's
    co-train command at a tiny size on the CPU): the model it trains and
    evaluates carries the score, and no hand kernel launches."""
    from vitvs_tpu_torch.train import train_servo

    seen = []
    real = tft.matching_quality
    monkey = pytest.MonkeyPatch()
    monkey.setattr(tft, "matching_quality",
                   lambda net, model, *a, **k: seen.append(model.vit) or real(net, model, *a, **k))
    before = {f: f.launches for f in (attention.mha_attention, attention.mha_attention_fast,
                                      matcher.dual_argmax_cosine_bf16)}
    try:
        res = train_servo.main(["--out", str(tmp_path / "c.npz"), "--steps", "2", "--batch", "1",
                                "--chain", "1", "--size", "56", "--poster", "synthetic",
                                "--device", "cpu", "--warmup", "1", "--layer", "0",
                                "--attn-score", score, "--kv-pool", "2"])
    finally:
        monkey.undo()
    assert res["finished"] and len(res["loss"]) == 2 and all(np.isfinite(res["loss"]))
    assert seen and all(v.attn_score == score and v.kv_pool == 2 for v in seen)
    assert all(f.launches == n for f, n in before.items())
