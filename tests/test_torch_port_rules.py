"""The port stands alone and chip_smoke.py's phases run: no module of
vitvs_tpu_torch nor chip_smoke.py imports JAX or vitvs_tpu; no CUDA source
includes PyTorch's headers and nothing uses torch.utils.cpp_extension; the
phase functions of chip_smoke.py (the bf16 main path and the int8 serving
step) run at tiny size on the CPU (plain versions, which is what the kernel
wrappers take for CPU tensors)."""

import ast
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from vitvs_tpu_torch.harness.pipeline import ServoModel
from vitvs_tpu_torch.io_bridge.config import VSConfig, load_config
from vitvs_tpu_torch.models import vit as tvit

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = (sorted((REPO / "vitvs_tpu_torch").rglob("*.py"))
              + [REPO / "chip_smoke.py", REPO / "scripts" / "port_measure.py",
                 REPO / "scripts" / "port_int8_tp_gap.py"])


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "vitvs_tpu", "flax", "optax", "orbax"), (path, mod)


def test_port_measure_imports_no_jax_at_run_time():
    """scripts/port_measure.py, which times the port on the card, brings in
    neither JAX nor vitvs_tpu when it is imported."""
    import subprocess
    import sys

    code = ("import sys, runpy; runpy.run_path('scripts/port_measure.py', run_name='x'); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'vitvs_tpu', 'orbax', 'flax', 'optax')]; assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_import_rule_covers_the_trainer():
    """The trainer's modules are among the files the import rule reads, and
    the rule bans optax with JAX (the port's optimizer is torch.optim)."""
    train = {p.name for p in PORT_FILES if p.parent.name == "train"}
    assert {"__init__.py", "finetune.py", "train_servo.py"} <= train
    for path in PORT_FILES:
        if path.parent.name == "train":
            assert not {m.split(".")[0] for m in _imported_modules(path)} & {"optax", "jax"}


def test_kernels_use_plain_c_interface():
    cu = sorted((REPO / "vitvs_tpu_torch" / "csrc").glob("*.cu"))
    assert [p.name for p in cu] == ["attention.cu", "attention_f32.cu", "attention_fast.cu",
                                    "attention_hd.cu", "attn_int8.cu", "matcher.cu"]
    for p in cu:
        text = p.read_text()
        assert "torch/extension.h" not in text and "ATen" not in text, p
        assert 'extern "C"' in text, p
    for p in PORT_FILES:
        assert "cpp_extension" not in p.read_text(), p


def test_chip_smoke_config_is_config_yaml():
    assert chip_smoke.reference_config() == load_config(REPO / "configs" / "config.yaml")


def test_chip_smoke_serving_config_is_config_vitb_518():
    assert chip_smoke.serving_config() == load_config(REPO / "configs" / "config_vitb_518.yaml")


def test_chip_smoke_kernel_phase_runs_on_cpu():
    assert chip_smoke.check_attention("cpu", shape=(1, 37, 2, 64)) == 0.0
    assert chip_smoke.check_attention("cpu", shape=(1, 37, 2, 64), dtype=torch.float32,
                                      tol=chip_smoke.ATTN_F32_TOL) == 0.0
    assert chip_smoke.check_matcher("cpu", shape=(50, 72)) == 0.0
    chip_smoke.check_matcher_exact("cpu", t=40, d=64)
    assert chip_smoke.check_matcher_bf16("cpu", shapes=[(50, 50, 72), (1, 3, 10), (9, 33, 20)]) == 0.0
    assert chip_smoke.check_attention_fast("cpu", shape=(1, 37, 2, 64)) == 0.0
    assert chip_smoke.check_int8_attention("cpu", shape=(1, 37, 2, 64)) == 0.0
    assert chip_smoke.check_quant_probe("cpu", shape=(1, 37, 2, 64)) == {"rows": 148}


def test_chip_smoke_bounds_follow_the_shapes():
    ms, by = chip_smoke.attention_bound_ms()
    assert by == "bytes" and ms == pytest.approx(4 * 485 * 6 * 64 * 2 / 3.35e12 * 1e3)  # q, k, v, o in bf16
    # the f32 step's exact attention: f32 FMA outside the tensor cores
    ms, by = chip_smoke.attention_bound_ms(f32=True)
    assert by == "operations" and ms == pytest.approx(4 * 6 * 485 ** 2 * 64 / 67e12 * 1e3)
    assert ms == pytest.approx(5.39e-3, rel=1e-3)
    # ... and f32 accurate on the tensor cores: three TF32 passes (split precision)
    ms, by = chip_smoke.attention_bound_ms(f32=True, tensor_cores=True)
    assert by == "operations" and ms == pytest.approx(3 * 4 * 6 * 485 ** 2 * 64 / 495e12 * 1e3)
    assert ms == pytest.approx(2.19e-3, rel=1e-2)
    ms, by = chip_smoke.attention_bound_ms(chip_smoke.SERVE_ATTN_SHAPE, f32=True,
                                           tensor_cores=True)
    assert by == "operations" and ms == pytest.approx(3 * 4 * 12 * 1370 ** 2 * 64 / 495e12 * 1e3)
    ms, by = chip_smoke.matcher_bound_ms()
    assert by == "operations" and ms == pytest.approx(2 * 484 ** 2 * 3456 / 67e12 * 1e3)
    # bf16 mode: bf16 rows read and the quartet written, on the bf16 tensor cores
    ms, by = chip_smoke.matcher_bound_ms(bf16=True)
    assert by == "bytes" and ms == pytest.approx((2 * 484 * 3456 * 2 + 2 * 484 * 8) / 3.35e12 * 1e3)
    # the serving kernels at ViT-B/14 @ 518: both bounded by operations
    ms, by = chip_smoke.attention_bound_ms(chip_smoke.SERVE_ATTN_SHAPE)
    assert by == "operations" and ms == pytest.approx(4 * 12 * 1370 ** 2 * 64 / 989e12 * 1e3)
    ms, by = chip_smoke.int8_attention_bound_ms()
    mm = 2 * 12 * 1370 ** 2 * 64
    assert by == "operations" and ms == pytest.approx((mm / 1979e12 + mm / 989e12) * 1e3)


def test_chip_smoke_main_path_runs_tiny_on_cpu():
    """The main-path phase with a tiny 2-block ViT on the CPU: both runs go
    through the plain versions, so they agree exactly and no kernel counts
    a launch."""
    cfg = VSConfig(u_max=96, v_max=72, f_x=75.0, f_y=75.0, dino_input_size=84,
                   num_pairs=12, layer=1, model_name="tiny", pinv_mode="dls")
    vcfg = tvit.ViTConfig(patch_size=14, embed_dim=96, depth=2, num_heads=3, pos_grid=5,
                          gelu_approx=True, model_name="tiny")
    model = ServoModel(vit=vcfg, cfg=cfg, compute_dtype=torch.bfloat16, device="cpu")
    net = tvit.init_vit(vcfg, torch.Generator().manual_seed(0), device="cpu",
                        layerscale=1.0).cast_blocks(torch.bfloat16).eval()
    summary = chip_smoke.run_main_path(net, cfg, model)
    assert summary["launches"] == {"attention": 0, "attention_f32": 0, "attention_hd": 0,
                                   "attention_hd_f32": 0, "attention_fast": 0,
                                   "attn_int8": 0, "matcher": 0, "matcher_bf16": 0}
    assert summary["differing_pairs"] == [0] * chip_smoke.N_STEPS
    assert summary["desc_rel_err"] == 0.0 and summary["twist_max_abs_err"] == 0.0
    assert summary["steps_compared"] == chip_smoke.N_STEPS
    assert len(summary["body_twist_last"]) == 6 and np.isfinite(summary["body_twist_last"]).all()


def test_chip_smoke_f32_step_runs_tiny_on_cpu():
    """Phase 3c with a tiny 2-block ViT on the CPU: the f32 step (f32
    blocks and descriptors, exact GELU) through the plain versions, held at
    the f32 tolerances."""
    cfg = VSConfig(u_max=96, v_max=72, f_x=75.0, f_y=75.0, dino_input_size=84,
                   num_pairs=12, layer=1, model_name="tiny", pinv_mode="dls")
    vcfg = tvit.ViTConfig(patch_size=14, embed_dim=96, depth=2, num_heads=3, pos_grid=5,
                          gelu_approx=False, model_name="tiny")
    model = ServoModel(vit=vcfg, cfg=cfg, compute_dtype=torch.float32, device="cpu")
    net = tvit.init_vit(vcfg, torch.Generator().manual_seed(0), device="cpu",
                        layerscale=1.0).eval()
    summary = chip_smoke.run_main_path(net, cfg, model, tol=chip_smoke.F32_TOL)
    assert summary["launches"] == dict.fromkeys(summary["launches"], 0)
    assert summary["differing_pairs"] == [0] * chip_smoke.N_STEPS
    assert summary["desc_rel_err"] == 0.0 and summary["twist_max_abs_err"] == 0.0
    assert np.isfinite(summary["body_twist_last"]).all()
    # the full-size f32 step chip_smoke.py drives: config.yaml's settings in f32
    net32, model32 = chip_smoke.f32_step(chip_smoke.reference_config(), "cpu")
    assert model32.compute_dtype == torch.float32 and not model32.vit.gelu_approx
    assert net32.compute_dtype == torch.float32 and model32.vit.embed_dim == 384


@pytest.mark.parametrize("variant", sorted(chip_smoke.VARIANTS))
def test_chip_smoke_serving_path_runs_tiny_on_cpu(variant):
    """The int8 serving phase with a tiny 2-block ViT on the CPU, bf16:
    calibration, then both runs through the plain versions."""
    cfg = VSConfig(u_max=96, v_max=72, f_x=75.0, f_y=75.0, dino_input_size=84,
                   num_pairs=12, layer=1, model_name="tiny", pinv_mode="dls")
    vcfg = tvit.ViTConfig(patch_size=14, embed_dim=128, depth=2, num_heads=2, pos_grid=5,
                          gelu_approx=True, model_name="tiny")
    fnet = tvit.init_vit(vcfg, torch.Generator().manual_seed(0), device="cpu",
                         layerscale=1.0).eval()
    summary, qnet, model = chip_smoke.run_serving_path(fnet, cfg, variant, "cpu", vit=vcfg)
    assert model.quantized and model.source_quantized_bins
    assert model.vit.quant_attn == chip_smoke.VARIANTS[variant][0]
    assert qnet.blocks[0].act_scales is not None and qnet.compute_dtype == torch.bfloat16
    assert summary["launches"] == dict.fromkeys(summary["launches"], 0)
    assert summary["differing_pairs"] == [0] * chip_smoke.N_STEPS
    assert summary["desc_rel_err"] == 0.0 and summary["twist_max_abs_err"] == 0.0
    assert np.isfinite(summary["body_twist_last"]).all()


def test_chip_smoke_frames_are_shifted_texture():
    cfg = VSConfig(u_max=64, v_max=48)
    goal, frames, depth = chip_smoke.make_frames(cfg, shifts=[(0, 0), (2, 3)])
    assert goal.shape == (48, 64, 3) and goal.dtype == np.uint8 and depth.shape == (48, 64)
    np.testing.assert_array_equal(frames[0], goal)
    np.testing.assert_array_equal(frames[1][:-2, :-3], goal[2:, 3:])


@pytest.fixture
def one_intra_op_thread():
    """Tiny shapes run thousands of small ops: one intra-op thread each, as
    the suite's parallel workers share the machine's cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chip_smoke_closed_loop_runs_tiny_on_cpu(tmp_path, one_intra_op_thread):
    """Phase 3d with a tiny 2-block ViT on a synthetic poster on the CPU:
    run_benchmark on episodes 0 and 1 (and 1 perturbed), the ladder
    stopping them at 5 iterations so that segments of 4 end in the frozen
    tail; through the plain versions, so no kernel counts a launch, the
    teacher-forced plain steps agree exactly and the plain episode never
    parts."""
    from vitvs_tpu_torch.sim.scene import Scene, make_synthetic_poster

    cfg = VSConfig(u_max=96, v_max=72, f_x=75.0, f_y=75.0, dino_input_size=84, num_pairs=12,
                   layer=1, model_name="tiny", pinv_mode="dls", lambda_=0.5,
                   min_iterations=2, max_iterations=5)
    vcfg = tvit.ViTConfig(patch_size=14, embed_dim=96, depth=2, num_heads=3, pos_grid=5,
                          gelu_approx=True, model_name="tiny")
    model = ServoModel(vit=vcfg, cfg=cfg, compute_dtype=torch.bfloat16, device="cpu")
    net = tvit.init_vit(vcfg, torch.Generator().manual_seed(0), device="cpu",
                        layerscale=1.0).cast_blocks(torch.bfloat16).eval()
    scene = Scene.create(make_synthetic_poster(128, seed=3), half_size=0.42, device="cpu")
    s = chip_smoke.run_closed_loop(net, cfg, model, scene, str(tmp_path), num_steps=12,
                                   segment_steps=4)
    assert s["device_steps"] == {"standard": 16, "perturbed": 8}
    assert s["iterations"] == {"standard": [5, 5], "perturbed": [5]}
    assert all(v == 0 for run in s["launches"].values() for v in run.values())
    tf = s["teacher_forced"]
    assert tf["steps"] == 8 and tf["flipped_pairs"] == 0 and tf["steps_compared"] == 8
    assert tf["twist_max_abs_err"] == 0.0 and tf["goal_desc_rel_err"] == 0.0
    assert s["plain_episode"]["parts_at_step"] is None
    assert s["chunk_steps"] == {"standard": 16, "perturbed": 8}     # one episode a chunk
    # the counts phase 3d asserts on the card: ViT-S/14 has 12 blocks; each
    # chunk's search is one forward and one match
    assert chip_smoke.loop_launches(11, 2, 80) == {"attention": 12 * 83, "matcher_bf16": 82}
    assert chip_smoke.loop_config(chip_smoke.reference_config()).max_iterations == \
        chip_smoke.LOOP_MAX_ITERATIONS


def test_chip_smoke_trained_chunk_runs_tiny_on_cpu(tmp_path, one_intra_op_thread):
    """Phase 3f with a tiny 2-block ViT on a synthetic poster on the CPU:
    episodes 0 to 2 as one chunk for 6 steps in segments of 4, each
    chunk-step teacher-forced through the plain step, then the same
    episodes one a chunk for 3 steps; through the plain versions, so no
    kernel counts a launch, every episode's pairs agree at every step and
    the twists exactly; the chunk runner of phase 4 takes a step."""
    from vitvs_tpu_torch.sim.scene import Scene, make_synthetic_poster

    cfg = VSConfig(u_max=96, v_max=72, f_x=75.0, f_y=75.0, dino_input_size=84, num_pairs=12,
                   layer=1, model_name="tiny", pinv_mode="dls", lambda_=0.5,
                   min_iterations=20, max_iterations=40, num_samples=5, num_circles=1)
    vcfg = tvit.ViTConfig(patch_size=14, embed_dim=96, depth=2, num_heads=3, pos_grid=5,
                          gelu_approx=True, model_name="tiny")
    model = ServoModel(vit=vcfg, cfg=cfg, compute_dtype=torch.bfloat16, device="cpu")
    net = tvit.init_vit(vcfg, torch.Generator().manual_seed(0), device="cpu",
                        layerscale=1.0).cast_blocks(torch.bfloat16).eval()
    scene = Scene.create(make_synthetic_poster(128, seed=3), half_size=0.42, device="cpu")
    s = chip_smoke.run_trained_chunk(net, cfg, model, scene, str(tmp_path), episodes=[0, 1, 2],
                                     num_steps=6, segment_steps=4, alone_steps=3)
    assert s["device_steps"] == 18 and s["chunk_steps"] == 6
    assert all(v == 0 for v in s["launches"].values())
    tf = s["teacher_forced"]
    assert tf["flips"] == [0, 0, 0] and tf["episode_steps_compared"] == 18
    assert tf["twist_max_abs_err"] == 0.0
    alone = s["alone"]
    assert alone["first_flip_step"] == [None] * 3 and alone["episode_steps_compared"] == 9
    assert alone["twist_max_abs_err"] == 0.0 and alone["search_quat_max_abs_diff"] == 0.0
    run = chip_smoke.chunk_runner(net, model, scene, 2)
    run()


def test_chip_smoke_and_the_loaders_import_no_jax_at_run_time():
    """Beside the static check above: importing chip_smoke.py and the weight
    loaders, and loading the exported weights, brings in neither JAX nor
    vitvs_tpu (the card's machine has neither)."""
    import subprocess
    import sys

    code = ("import sys, chip_smoke; from vitvs_tpu_torch.models import convert; "
            "convert.load_exported(convert.TRAINED_S518); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'vitvs_tpu', 'orbax', 'flax', 'optax')]; assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert not (REPO / "vitvs_tpu_torch" / "export_port_weights.py").exists()
    assert "import jax" in (REPO / "scripts" / "export_port_weights.py").read_text()


def test_chip_smoke_trained_config_is_real_s518():
    # the benchmark runs draw from the 500-episode stream, as runs Z and AA did
    cfg = chip_smoke.trained_config()
    assert cfg == load_config(REPO / "configs" / "real_s518.yaml").replace(num_samples=500)
    assert (cfg.dino_input_size, cfg.min_iterations, cfg.max_iterations) == (518, 300, 1500)
    model = ServoModel.create(cfg, device="cpu")
    net, info = chip_smoke.load_trained(model)
    assert info["file"] == "vitvs_tpu_torch/assets/ckpt_real518.npz"
    assert info["parameters"] == 22055424 and info["config"]["num_heads"] == 6
    assert net.compute_dtype == torch.float32 and net.cfg == model.vit and model.vit.gelu_approx
    with pytest.raises(FileNotFoundError):
        chip_smoke.load_trained(model, REPO / "vitvs_tpu_torch" / "assets" / "missing.npz")
    with pytest.raises(ValueError, match="the model runs"):
        chip_smoke.load_trained(ServoModel.create(chip_smoke.serving_config(), device="cpu"))


def test_chip_smoke_trained_phase_runs_tiny_on_cpu(tmp_path, one_intra_op_thread):
    """Phase 3e's functions with a tiny 2-block ViT on a synthetic poster on
    the CPU: the bf16 step and the int8 variants through the plain versions
    (no launch counted, kernel and plain runs equal), and the closed loop,
    which a random tiny ViT does not converge in 12 steps: the phase then
    raises, naming where the plain rerun parts."""
    from vitvs_tpu_torch.sim.scene import Scene, make_synthetic_poster

    cfg = VSConfig(u_max=96, v_max=72, f_x=75.0, f_y=75.0, dino_input_size=84, num_pairs=12,
                   layer=1, model_name="tiny", pinv_mode="dls", min_iterations=2,
                   max_iterations=5)
    vcfg = tvit.ViTConfig(patch_size=14, embed_dim=128, depth=2, num_heads=2, pos_grid=5,
                          gelu_approx=True, model_name="tiny")
    model = ServoModel(vit=vcfg, cfg=cfg, compute_dtype=torch.bfloat16, device="cpu")
    fnet = tvit.init_vit(vcfg, torch.Generator().manual_seed(0), device="cpu",
                         layerscale=1.0).eval()
    net = tvit.init_vit(vcfg, torch.Generator().manual_seed(0), device="cpu",
                        layerscale=1.0).cast_blocks(torch.bfloat16).eval()
    scene = Scene.create(make_synthetic_poster(128, seed=3), half_size=0.42, device="cpu")
    s = chip_smoke.run_trained_step(net, cfg, model, scene)
    steps = s.pop("steps")
    assert len(steps) == chip_smoke.N_STEPS and s["differing_pairs"] == [0] * chip_smoke.N_STEPS
    assert s["launches"] == dict.fromkeys(s["launches"], 0) and s["twist_max_abs_err"] == 0.0
    gap = chip_smoke.run_trained_int8(fnet, cfg, "cpu", scene, steps, vit=vcfg)
    for variant, g in gap.items():
        assert g["summary"]["differing_pairs"] == [0] * chip_smoke.N_STEPS, variant
        assert len(g["pairs_agreeing_with_bf16"]) == chip_smoke.N_STEPS and g["pairs"] == 12
        assert np.isfinite(g["twist_gap_to_bf16"])
    with pytest.raises(AssertionError, match="did not converge.*part at step"):
        chip_smoke.run_trained_loop(net, cfg, model, scene, str(tmp_path), forced=4,
                                    num_steps=12, segment_steps=4)


def test_chip_smoke_replay_stops_at_its_budget_and_resumes(tmp_path):
    """--replay on the CPU with no time budget: the rotation search of
    episode 0 at ViT-S/14 @ 518 runs and is checkpointed, the episode in
    flight is dropped at its first step, and a second call resumes from the
    same checkpoint (the search is not run again)."""
    ckpt = tmp_path / "replay.ckpt"
    out = chip_smoke.run_replay(0, 1, ckpt, 0.0, tmp_path / "out", "cpu")
    assert not out["finished"] and out["episodes_done"] == 0 and out["call_steps"] == 1
    assert ckpt.exists() and out["weights"] == "vitvs_tpu_torch/assets/ckpt_real518.npz"
    again = chip_smoke.run_replay(0, 1, ckpt, 0.0, tmp_path / "out", "cpu")
    assert not again["finished"] and again["call_steps"] == 1 and again["episodes_this_call"] == 0


def test_chip_smoke_ad_config_is_real_s518_pool2mm():
    """Phase 3g and --replay --int8 run configs/real_s518_pool2mm.yaml (run
    AD's) on the 500-episode stream; its int8 model is what run_benchmark
    serves, and K/V pooled before the projection is real_s518_pool2mmpre's."""
    cfg = chip_smoke.ad_config()
    assert cfg == load_config(REPO / "configs" / "real_s518_pool2mm.yaml").replace(
        num_samples=500)
    pre = load_config(REPO / "configs" / "real_s518_pool2mmpre.yaml").replace(num_samples=500)
    assert pre == cfg.replace(kv_pool_where="pre")
    model = ServoModel.create(cfg, device="cpu")
    q = chip_smoke.int8_model(model)
    assert q.quantized and q.source_quantized_bins and q.pp_precision == "default"
    assert (q.vit.quant_attn, q.vit.patch_embed_impl, q.vit.kv_pool, q.vit.kv_pool_impl,
            q.vit.kv_pool_where) == ("nomax3", "conv", 2, "matmul", "post")
    qpre = chip_smoke.int8_model(model, "reshape", "pre")
    assert (qpre.vit.patch_embed_impl, qpre.vit.kv_pool_where, qpre.cfg) == ("reshape", "pre", pre)
    # the exported weights load into the AD model (its run settings aside)
    net, _ = chip_smoke.load_trained(model)
    assert net.cfg == model.vit
    assert chip_smoke.replay_name(0, 500, int8=True) == "replay_s518_int8_0_500"
    assert chip_smoke.replay_name(0, 500) == "replay_s518_0_500"


def test_chip_smoke_int8_chunk_runs_tiny_on_cpu(tmp_path, one_intra_op_thread):
    """Phase 3g with a tiny 2-block ViT (2 x 2 K/V pooling) on a synthetic
    poster on the CPU: run_benchmark(quantized=True, int8_static=True) on
    episodes 0 to 2 as one chunk for 6 steps in segments of 4, its first 3
    chunk-steps teacher-forced through the same step on CPU tensors (equal:
    it ran there), then one a chunk for 3 steps; no kernel counts a launch;
    the bench.py graph beside it and the preprocess gap (none on the CPU);
    the int8 chunk runner of phase 4 takes a step."""
    from vitvs_tpu_torch.sim.scene import Scene, make_synthetic_poster

    cfg = VSConfig(u_max=96, v_max=72, f_x=75.0, f_y=75.0, dino_input_size=84, num_pairs=12,
                   layer=1, model_name="tiny", pinv_mode="dls", lambda_=0.5,
                   min_iterations=20, max_iterations=40, num_samples=5, num_circles=1,
                   kv_pool=2, kv_pool_impl="matmul")
    vcfg = tvit.ViTConfig(patch_size=14, embed_dim=96, depth=2, num_heads=3, pos_grid=5,
                          gelu_approx=True, model_name="tiny", kv_pool=2, kv_pool_impl="matmul")
    model = ServoModel(vit=vcfg, cfg=cfg, compute_dtype=torch.bfloat16, device="cpu")
    fnet = tvit.init_vit(vcfg, torch.Generator().manual_seed(0), device="cpu",
                         layerscale=1.0).eval()
    scene = Scene.create(make_synthetic_poster(128, seed=3), half_size=0.42, device="cpu")
    s = chip_smoke.run_int8_chunk(fnet, cfg, model, scene, str(tmp_path), episodes=[0, 1, 2],
                                  num_steps=6, segment_steps=4, forced=3, alone_steps=3)
    run = s.pop("run")
    assert run.model.quantized and run.model.vit.quant_attn == "nomax3"
    assert s["device_steps"] == 18 and s["chunk_steps"] == 6
    assert all(v == 0 for v in s["launches"].values())
    tf = s["teacher_forced"]
    assert tf["steps"] == 3 and tf["flips"] == [0, 0, 0] and tf["episode_steps_compared"] == 9
    assert tf["twist_max_abs_err"] == 0.0
    alone = s["alone"]
    assert alone["first_flip_step"] == [None] * 3 and alone["episode_steps_compared"] == 9
    assert alone["twist_max_abs_err"] == 0.0
    graph = chip_smoke.compare_bench_graph(fnet, model, scene)
    assert len(graph["pairs_agreeing"]) == chip_smoke.N_STEPS and graph["pairs"] == 12
    assert np.isfinite(graph["twist_gap"])
    assert chip_smoke.preprocess_gap(model, scene) == {"max_abs_gap": 0.0, "share_apart": 0.0}
    chip_smoke.chunk_runner(run.net, run.model, scene, 2)()


def test_chip_smoke_int8_replay_is_its_own_run(tmp_path):
    """--replay --int8 on the CPU with no time budget: run AD's int8
    configuration calibrates, searches episode 0's start at ViT-S/14 @ 518,
    checkpoints, and drops the episode in flight at its first step; the
    checkpoint is not a bf16 replay's (its fingerprint says quantized), so
    the bf16 replay refuses to resume from it."""
    ckpt = tmp_path / f"{chip_smoke.replay_name(0, 1, int8=True)}.ckpt"
    out = chip_smoke.run_replay(0, 1, ckpt, 0.0, tmp_path / "out", "cpu", int8=True)
    assert out["int8"] and not out["finished"] and out["call_steps"] == 1
    assert out["episodes_done"] == 0 and ckpt.exists()
    with pytest.raises(ValueError, match="different run"):
        chip_smoke.run_replay(0, 1, ckpt, 0.0, tmp_path / "out", "cpu")


def test_chip_smoke_real64_config_is_real64_yaml():
    """Phase 3h and --replay --method run configs/real64.yaml (runs J, K and
    AN's 64-episode stream), built in code."""
    assert chip_smoke.real64_config() == load_config(REPO / "configs" / "real64.yaml")


@pytest.mark.parametrize("method", ["sift", "orb"])
def test_chip_smoke_classical_chunk_runs_tiny_on_cpu(method, tmp_path, one_intra_op_thread):
    """Phase 3h at a 128 x 128 camera on a smooth seeded poster on the CPU:
    episodes 0 to 2 as one chunk for 6 steps, run twice; chunk-steps 0 and
    3 against the CPU port (equal: they ran there), the Hamming distances
    (ORB) bit for bit, each episode alone for 3 steps; no kernel counts a
    launch; then the classical profile runner takes a chunk-step at full
    size."""
    from scipy.ndimage import zoom

    from vitvs_tpu_torch.sim.scene import Scene

    rng = np.random.default_rng(11)
    tex = np.clip(zoom(rng.random((32, 32, 3)), (8, 8, 1), order=3), 0, 1).astype(np.float32)
    scene = Scene.create(tex, half_size=0.42, device="cpu")
    cfg = VSConfig(u_max=128, v_max=128, f_x=100.5, f_y=100.5, num_pairs=16, lambda_=0.5,
                   control_dt=0.1, pinv_mode="dls", num_samples=8, num_circles=2,
                   min_iterations=4, max_iterations=40)
    s = chip_smoke.run_classical_chunk(method, cfg, scene, str(tmp_path), episodes=[0, 1, 2],
                                       num_steps=6, compared=(0, 3), alone_steps=3,
                                       max_corners=64)
    assert s["device_steps"] == 18 and s["chunk_steps"] == s["chunk_steps_again"] == 6
    assert all(v == 0 for v in s["launches"].values())
    assert s["goal_keypoints_same_on_cpu"] and s["goal_keypoints"] > 0
    cpu = s["cpu"]
    assert cpu["chunk_steps"] == [0, 3] and cpu["frames"] == 6
    assert cpu["frames_with_same_keypoints"] == cpu["frames_with_same_pairs"] == 6
    assert cpu["twist_max_abs_err"] == 0.0
    assert (cpu["hamming_distances_bit_for_bit"] > 0) == (method == "orb")
    assert s["alone"] == {"first_flip_step": [None] * 3, "twist_max_abs_err": 0.0}
    chip_smoke.classical_runner(method, scene, 2)()


def test_chip_smoke_classical_and_perturbed_replays_are_their_own_runs(tmp_path, monkeypatch):
    """--replay --method and --replay --perturbed each name their own files
    and fingerprint their own runs.  A classical replay (no ViT) at
    real64's settings stops at its budget after one chunk-step, before any
    checkpoint; cut to 2 steps at a 128 x 128 camera it finishes episode 0
    and leaves a checkpoint that another method's or the perturbed run's
    replay refuses.  The perturbed dino replay's checkpoint is not the
    standard one's."""
    assert chip_smoke.replay_name(0, 64, method="sift") == "replay_sift_0_64"
    assert chip_smoke.replay_name(0, 64, perturbed=True, method="orb") == "replay_orb_pert_0_64"
    assert chip_smoke.replay_name(0, 500, perturbed=True) == "replay_s518_pert_0_500"
    ckpt = tmp_path / "harris.ckpt"
    out = chip_smoke.run_replay(0, 1, ckpt, 0.0, tmp_path / "out", "cpu", method="harris")
    assert out["method"] == "harris" and out["weights"] is None
    assert not out["finished"] and out["call_steps"] == 1 and not ckpt.exists()
    small = chip_smoke.real64_config().replace(u_max=128, v_max=128, f_x=100.5, f_y=100.5,
                                                min_iterations=1, max_iterations=2)
    monkeypatch.setattr(chip_smoke, "real64_config", lambda: small)
    out = chip_smoke.run_replay(0, 1, ckpt, 60.0, tmp_path / "out", "cpu", method="harris")
    assert out["finished"] and out["episodes_done"] == 1 and ckpt.exists()
    for kw in (dict(method="sift"), dict(method="harris", perturbed=True)):
        with pytest.raises(ValueError, match="different run"):
            chip_smoke.run_replay(0, 1, ckpt, 0.0, tmp_path / "out", "cpu", **kw)
    pert = tmp_path / "pert.ckpt"
    out = chip_smoke.run_replay(0, 1, pert, 0.0, tmp_path / "out", "cpu", perturbed=True)
    assert out["perturbed"] and not out["finished"] and out["call_steps"] == 1
    with pytest.raises(ValueError, match="different run"):
        chip_smoke.run_replay(0, 1, pert, 0.0, tmp_path / "out", "cpu")


def _tiny_train_vit():
    return tvit.ViTConfig(patch_size=14, embed_dim=64, depth=2, num_heads=2, pos_grid=4,
                          model_name="tiny", gelu_approx=True)


def test_chip_smoke_training_phase_runs_tiny_on_cpu(tmp_path, one_intra_op_thread):
    """Phase 3i with a tiny 2-block ViT on the real poster on the CPU:
    (a) the card-against-CPU step (here CPU against CPU: equal), (b) steps
    from scratch with no hand kernel launched, (c) matching quality with
    kernels and plain (the plain versions on CPU tensors: equal; 2 forwards
    of the layers and one batched matcher call), resumed steps, (d) save,
    load and one servo step.  A bound the tiny run misses raises."""
    from vitvs_tpu_torch.models.convert import save_exported
    from vitvs_tpu_torch.sim.scene import load_poster_scene

    vit = _tiny_train_vit()
    g = chip_smoke.check_train_grads("cpu", size=56, vit=vit)
    assert g["loss_rel_err"] == 0.0 and g["grad_cos_min"] > 0.999999 and g["params"] == 32
    net = tvit.init_vit(vit, torch.Generator().manual_seed(0), device="cpu", layerscale=1.0)
    path = tmp_path / "tiny.npz"
    save_exported(path, net.state_dict(), vit, "bfloat16")
    scene = load_poster_scene(device="cpu")
    kw = dict(steps=4, resume_steps=2, path=path, size=56, resume_size=70, batch=2, chain=2,
              views=2, profile=False, vit=vit)
    out = chip_smoke.run_training("cpu", scene, early=(10.0, -10.0), quality_min=(0.0, 0.0),
                                  resume_max=10.0, **kw)
    assert len(out["scratch"]["losses"]) == 4 and len(out["resume"]["losses"]) == 2
    q = out["resume"]["quality"]
    assert q["kernels"] == q["plain"]
    assert q["launches"] == dict.fromkeys(q["launches"], 0)   # CPU tensors: plain versions
    assert out["served"]["launches"] == dict.fromkeys(q["launches"], 0)
    assert np.isfinite(out["served"]["body_twist"]).all()
    with pytest.raises(AssertionError, match="from scratch"):
        chip_smoke.run_training("cpu", scene, **kw)


def test_chip_smoke_train_command_runs_tiny_on_cpu(tmp_path, one_intra_op_thread):
    """--train on the CPU: train_servo at 56 px for 2 steps in chains of 1 on
    the synthetic poster (the JAX run's);
    the summary JSON and the bf16 weights land in chiprun_out/, the loss
    windows appear only where the run reaches them, and no bounds are held
    outside the JAX run's configuration."""
    from vitvs_tpu_torch.models.convert import load_exported

    res = chip_smoke.run_train_command(2, 56, None, None, tmp_path, "cpu",
                                       extra_argv=["--chain", "1", "--batch", "1", "--layer", "0"])
    assert res["finished"] and res["done"] == 2 and res["windows"] == {}
    assert res["poster"] == "synthetic"
    assert "bounds" not in res and len(res["final_matching"]) == 2
    saved = json.loads((tmp_path / "chiprun_out" / "train_s56_2.json").read_text())
    assert len(saved["loss"]) == 2
    sd, cfg = load_exported(tmp_path / "chiprun_out" / "train_s56_2_bf16.npz")
    assert cfg == tvit.make_config("dinov2_vits14") and sd["blocks.0.attn.qkv.weight"].dtype == torch.bfloat16


def test_chip_smoke_score_phase_runs_tiny_on_cpu(one_intra_op_thread):
    """Phase 3j's functions with tiny models on the CPU: the relu step
    through the plain versions (no launch), the int8 serving step in each of
    'none', 'nomax3', 'pv' and 'qk+pv' (kernel and plain runs equal) and
    their twist gaps, block 0 card against CPU (here CPU against CPU:
    equal), and the int8 products against the int64 product."""
    from vitvs_tpu_torch.sim.scene import Scene, make_synthetic_poster

    cfg = VSConfig(u_max=96, v_max=72, f_x=75.0, f_y=75.0, dino_input_size=84, num_pairs=12,
                   layer=1, model_name="tiny", pinv_mode="dls", attn_score="relu")
    vcfg = tvit.ViTConfig(patch_size=14, embed_dim=128, depth=2, num_heads=2, pos_grid=5,
                          gelu_approx=True, model_name="tiny", attn_score="relu")
    model = ServoModel(vit=vcfg, cfg=cfg, compute_dtype=torch.bfloat16, device="cpu")
    fnet = tvit.init_vit(vcfg, torch.Generator().manual_seed(0), device="cpu",
                         layerscale=1.0).eval()
    net = tvit.init_vit(vcfg, torch.Generator().manual_seed(0), device="cpu",
                        layerscale=1.0).cast_blocks(torch.bfloat16).eval()
    scene = Scene.create(make_synthetic_poster(128, seed=3), half_size=0.42, device="cpu")
    s = chip_smoke.run_trained_step(net, cfg, model, scene)
    steps = s.pop("steps")
    assert s["launches"] == dict.fromkeys(s["launches"], 0) and s["twist_max_abs_err"] == 0.0
    soft = dataclasses.replace(vcfg, attn_score="softmax")
    gap = chip_smoke.run_trained_int8(fnet, dataclasses.replace(cfg, attn_score="softmax"),
                                      "cpu", scene, steps, vit=soft,
                                      variants=tuple(chip_smoke.PROB_VARIANTS))
    assert sorted(gap) == sorted(chip_smoke.PROB_VARIANTS)
    for variant, g in gap.items():
        assert g["summary"]["differing_pairs"] == [0] * chip_smoke.N_STEPS, variant
        assert g["summary"]["launches"] == dict.fromkeys(g["summary"]["launches"], 0)
    gaps = chip_smoke.twist_gaps({k: g["summary"] for k, g in gap.items()})
    assert set(gaps) == {"nomax3-none", "pv-none", "qk+pv-none", "none-nomax3", "pv-nomax3",
                         "qk+pv-nomax3"} and all(np.isfinite(list(gaps.values())))
    for variant in ("pv", "qk+pv"):
        smodel = chip_smoke.serving_model(cfg, variant, "cpu", vit=soft)
        assert smodel.vit.quant_attn == variant and smodel.vit.attn_score == "softmax"
        goal, frames, _ = chip_smoke.make_frames(cfg)
        qnet = chip_smoke.quantized_vit(fnet, smodel, [goal, *frames])
        b = chip_smoke.check_int8_block(qnet, smodel, goal)
        assert b["rel_err"] == 0.0 and b["token_cos_min"] > 0.9999
    relu_int8 = chip_smoke.serving_model(cfg, "nomax3", "cpu", vit=vcfg)
    assert relu_int8.vit.attn_score == "relu" and relu_int8.vit.quant_attn == "nomax3"
    prods = chip_smoke.check_int8_products("cpu", shape=(1, 70, 2, 64), rows=4)
    assert prods["pv"]["depth"] == 70 and prods["qk"]["depth"] == 64


def test_chip_smoke_score_configs_are_the_relu_yamls():
    """3j(a)'s configurations: configs/real_s518_relu.yaml and
    real_s518_relupool.yaml on the 500-episode stream, and the trained
    weights load under them (the file holds the architecture; the score is
    the run's setting)."""
    for name, pool in (("real_s518_relu", 1), ("real_s518_relupool", 2)):
        cfg = chip_smoke.score_config("relu", pool)
        assert cfg == load_config(REPO / "configs" / f"{name}.yaml").replace(num_samples=500)
    model = ServoModel.create(chip_smoke.score_config("sqrelu"), device="cpu")
    net, _ = chip_smoke.load_trained(model)
    assert net.cfg.attn_score == "sqrelu" and net.cfg == model.vit
    assert chip_smoke.replay_name(0, 64, attn_score="relu") == "replay_s518_relu_0_64"
    assert chip_smoke.replay_name(0, 64) == "replay_s518_0_64"


def test_chip_smoke_cotrain_command_names_its_score(tmp_path, one_intra_op_thread):
    """--cotrain's training: train_servo with --attn-score at 56 px for 2
    steps; its files are named for the score and its summary has the 25-step
    windows the run reached (none here)."""
    res = chip_smoke.run_train_command(2, 56, None, None, tmp_path, "cpu", attn_score="relu",
                                       extra_argv=["--chain", "1", "--batch", "1", "--layer",
                                                   "0", "--kv-pool", "2"])
    assert res["finished"] and res["name"] == "train_s56_2_relu" and res["attn_score"] == "relu"
    assert res["windows_25"] == []
    assert (tmp_path / "chiprun_out" / "train_s56_2_relu.json").exists()


def test_chip_smoke_score_train_check_runs_tiny_on_cpu(one_intra_op_thread):
    """3j(e) with a tiny 2-block ViT (LayerScale 1, so the relu attention
    carries the loss) on the CPU: card and CPU are the same device here, so
    the f32 and bf16 steps agree exactly, and the bf16 gradients lie as far
    from the f64 ones on one side as on the other."""
    vit = _tiny_train_vit()
    net = tvit.init_vit(vit, torch.Generator().manual_seed(0), device="cpu", layerscale=1.0)
    out = chip_smoke.check_score_train_grads("cpu", net.state_dict(), size=56, vit=vit)
    assert out["params"] == 32
    for name in ("f32", "bf16"):
        assert out[name]["loss_rel_err"] == 0.0 and out[name]["grad_cos_min"] > 0.999999
    assert out["bf16"]["f64_cos_min_card"] == out["bf16"]["f64_cos_min_cpu"]
    assert out["f32"]["f64_cos_min_card"] > out["bf16"]["f64_cos_min_card"]


def _tree(path: Path) -> dict:
    """Every file under ``path``: its size and modification time."""
    return {str(p.relative_to(path)): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in sorted(path.rglob("*")) if p.is_file()}


def test_native_library_builds_only_into_the_port_build_directory(tmp_path):
    """The port builds native/sensor_bridge.cpp as it stands into its own
    build directory (vitvs_tpu_torch/_build/ by default), under a name that
    carries the source's hash, and writes nothing under native/: four
    builds at once into one empty directory leave one library and no
    temporary file; the port's sources never run make."""
    import threading

    from vitvs_tpu_torch.io_bridge import native
    from vitvs_tpu_torch.ops import _build

    assert native.SOURCE == REPO / "native" / "sensor_bridge.cpp"
    assert native.build_library.__defaults__ == (_build.BUILD_DIR,)
    assert _build.BUILD_DIR == REPO / "vitvs_tpu_torch" / "_build"
    if native.native_available():
        assert Path(native._load()._name).parent == _build.BUILD_DIR
    before = _tree(REPO / "native")
    out = tmp_path / "build"
    got, errors = [], []

    def build():
        try:
            got.append(native.build_library(out))
        except Exception as e:           # a compiler missing here fails every thread alike
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    if errors:
        assert all("no C++ compiler" in str(e) for e in errors), errors
    else:
        assert len(set(got)) == 1 and got[0].parent == out
        assert [p.name for p in out.iterdir()] == [got[0].name]
        assert got[0].name.startswith("libsensor_bridge-") and got[0].suffix == ".so"
    assert _tree(REPO / "native") == before
    for path in PORT_FILES:
        text = path.read_text()
        assert '"make"' not in text and "Makefile" not in text.replace("the Makefile's", ""), path


def _tiny_mesh_setup():
    """A tiny 2-block ViT of 4 heads (LayerScale 1) and its servo model on
    the CPU, and a synthetic poster scene."""
    from vitvs_tpu_torch.sim.scene import Scene, make_synthetic_poster

    cfg = VSConfig(u_max=96, v_max=72, f_x=75.0, f_y=75.0, dino_input_size=84, num_pairs=12,
                   layer=1, model_name="tiny", pinv_mode="dls", num_samples=8,
                   min_iterations=8, max_iterations=8)
    vcfg = tvit.ViTConfig(patch_size=14, embed_dim=96, depth=2, num_heads=4, pos_grid=5,
                          gelu_approx=True, model_name="tiny")
    model = ServoModel(vit=vcfg, cfg=cfg, compute_dtype=torch.bfloat16, device="cpu")
    net = tvit.init_vit(vcfg, torch.Generator().manual_seed(0), device="cpu",
                        layerscale=1.0).cast_blocks(torch.bfloat16).eval()
    scene = Scene.create(make_synthetic_poster(128, seed=3), half_size=0.42, device="cpu")
    return net, cfg, model, scene


def test_chip_smoke_mesh_check_rejects_a_scrambled_split(monkeypatch, one_intra_op_thread):
    """Phase 3l(d) refuses a tp split whose two shards project their heads'
    outputs through each other's columns of the output projection: the
    teacher-forced steps or the goal descriptors disagree with the unsplit
    ViT's."""
    from vitvs_tpu_torch.parallel import mesh as tmesh

    def swapped(self, blk, devices, _init=tmesh.TPBlock.__init__):
        _init(self, blk, devices)
        a, b = self.shards[0], self.shards[1]
        a.proj, b.proj = b.proj, a.proj

    net, cfg, model, scene = _tiny_mesh_setup()
    monkeypatch.setattr(tmesh.TPBlock, "__init__", swapped)
    with pytest.raises(AssertionError):
        chip_smoke.run_mesh(net, cfg, model, scene, episodes=[0, 1, 2, 3], num_steps=4,
                            segment_steps=2)


def test_chip_smoke_pixel_phase_runs_tiny_on_cpu(tmp_path, one_intra_op_thread):
    """Phase 3l's parts on the CPU at small size (plain versions: no kernel
    counts a launch): the any-width kernel's checks, the mesh against one
    device (a (2, 2) grid of the CPU, a tiny 2-block ViT of 4 heads), the
    sensors at 640 x 480, the live channel, the native bridge's round trip
    and ServoLoop over it, and the stage timer and trace; the launches the
    mesh and the pixel8 episode must give on the card."""
    assert chip_smoke.check_attention_hd("cpu") == dict.fromkeys(chip_smoke.PIXEL_HD, 0.0)
    net, cfg, model, scene = _tiny_mesh_setup()
    m = chip_smoke.run_mesh(net, cfg, model, scene, episodes=[0, 1, 2, 3], num_steps=4,
                            segment_steps=2)
    assert m["shard_heads"] == [2] and m["chunk_steps"] == 4
    assert m["teacher_forced"]["episode_steps_compared"] >= 4
    assert all(v == 0 for v in m["launches"].values())
    # two blocks: the goal on row 0's two shards, two rows' search, 4 chunk-steps
    assert m["launches_on_the_card"]["attention"] == 2 * 2 * (1 + 2 + 2 * 4)
    assert m["launches_on_the_card"]["matcher_bf16"] == 2 * (1 + 4)
    s = chip_smoke.check_sensors("cpu")
    assert s["ir_shape"] == [480, 640] and s["cloud_max_abs_err"] == 0.0
    live = chip_smoke.run_live(net, cfg, model, scene, tmp_path, num_steps=4, segment_steps=2)
    assert live["files"] == ["ep0000_step00002.png", "ep0000_step00004.png"]
    nat = chip_smoke.run_native(net, model, scene)
    assert nat["round_trip"] and nat["viz_frames"] == chip_smoke.N_STEPS
    st = chip_smoke.run_stages(net, model, scene, tmp_path / "trace", iters=2)
    assert set(st["stages_mean_ms"]) == {"render", "preprocess", "vit+bin", "match",
                                         "servo_step (whole)"}
    assert chip_smoke.pixel_config().model_name == chip_smoke.PIXEL_MODEL
    assert chip_smoke.pixel_loop_config().max_iterations == 120


def _tiny_int8_tp_setup():
    """A tiny int8 ViT of 4 heads at run AD's settings (static scales,
    'nomax3', 2 x 2 K/V pooling by the matrix), its config, model and scene,
    and the base of the configs."""
    from vitvs_tpu_torch.sim.scene import Scene, make_synthetic_poster

    scene = Scene.create(make_synthetic_poster(128, seed=3), half_size=0.42, device="cpu")
    base = dict(u_max=96, v_max=72, f_x=75.0, f_y=75.0, dino_input_size=84, num_pairs=12,
                layer=1, model_name="tiny", pinv_mode="dls")
    cfg = VSConfig(**base, num_samples=8, min_iterations=8, max_iterations=8, kv_pool=2,
                   kv_pool_impl="matmul")
    vcfg = tvit.ViTConfig(patch_size=14, embed_dim=128, depth=2, num_heads=4, pos_grid=5,
                          gelu_approx=True, model_name="tiny", kv_pool=2, kv_pool_impl="matmul")
    model = ServoModel(vit=vcfg, cfg=cfg, compute_dtype=torch.bfloat16, device="cpu")
    fnet = tvit.init_vit(vcfg, torch.Generator().manual_seed(0), device="cpu",
                         layerscale=1.0).eval()
    qnet, qmodel = chip_smoke.int8_serving_of_stream(fnet, model, scene)
    return qnet, cfg, qmodel, scene, base


def test_chip_smoke_int8_tp_phase_runs_tiny_on_cpu(one_intra_op_thread):
    """Phase 3m's parts on the CPU at small size (plain versions: no kernel
    counts a launch): (a) a tiny int8 ViT of 4 heads at run AD's settings
    (static scales, 'nomax3', 2 x 2 K/V pooling) on a (2, 2) grid of the
    CPU, teacher-forced through the unsplit: every twist equal to the bit,
    the shards' attention run 2 x 2 x (1 + 2 + 2 a chunk-step) times, and
    the planted fault failing the check; (b)
    'fused' and 'none' ViTs of 4 heads of 64 over tp = 2: equal to the
    unsplit, the shards' kernel 4 (its plain version here) equal to the
    unsplit's heads; (c) the bf16-logits check on CPU tensors; (d) the
    launches port_measure.py's chains give."""
    qnet, cfg, qmodel, scene, base = _tiny_int8_tp_setup()
    a = chip_smoke.run_int8_tp(qnet, cfg, qmodel, scene, episodes=[0, 1, 2, 3], num_steps=4,
                               segment_steps=2)
    tf = a["teacher_forced"]
    assert a["shard_heads"] == [2] and a["chunk_steps"] == 4 and a["goal_desc_bit_equal"]
    assert a["shard_attention_calls"] == 2 * 2 * (1 + 2 + 2 * 4)
    assert tf["flips"] == [0] * 4 and tf["twist_max_abs_err"] == 0.0 and a["failed"] == []
    assert tf["episode_steps_bit_equal"] == tf["episode_steps_compared"] == 16
    plant = chip_smoke.run_int8_tp_plant(qnet, cfg, qmodel, scene, num_steps=2)
    assert "goal descriptors bit for bit" in plant["failed"]

    bcfg = VSConfig(**base)
    bvit = tvit.ViTConfig(patch_size=14, embed_dim=256, depth=2, num_heads=4, pos_grid=5,
                          gelu_approx=True, model_name="tiny")
    bnet = tvit.init_vit(bvit, torch.Generator().manual_seed(1), device="cpu",
                         layerscale=1.0).eval()
    variants = {}
    for name, variant, kernel in (("fused", "F", "attn_int8"), ("none", "none", "attention")):
        _, q, m = chip_smoke.run_serving_path(bnet, bcfg, variant, "cpu", vit=bvit)
        variants[name] = (q, m, kernel)
    b = chip_smoke.run_int8_tp_serving(variants, bcfg)
    for name, summ in b.items():
        assert summ["launches"] == dict.fromkeys(summ["launches"], 0)
        assert summ["launches_on_the_card"][variants[name][2]] == 2 * 2 * (1 + chip_smoke.N_STEPS)
        assert summ["steps_bit_equal"] == chip_smoke.N_STEPS and summ["twist_max_abs_err"] == 0.0
    sk = b["fused"]["shard_kernels"]
    assert sk["bit_equal"] == [True, True] and sk["column_offset_bytes"] == [256, 256]
    assert max(sk["max_abs_err_vs_plain"]) == 0.0
    c = chip_smoke.check_bf16l("cpu", shapes=((1, 37, 2, 64),))["(1, 37, 2, 64)"]
    assert c["max_abs_err"] == c["mean_abs_err"] == 0.0 and c["exact_kernel_mean_abs_err"] > 0
    # (d): a goal forward and 3 chains of 2 and 10 iterations of 12 blocks
    assert chip_smoke.measure_launches("step", 12, 2, 10, 2) == 12 * (1 + 36)
    assert chip_smoke.measure_launches("attn", 12, 2, 10, 2) == 12 + 36
    assert chip_smoke.measure_launches("match", 12, 2, 10, 2) == 12


def test_chip_smoke_int8_tp_check_rejects_a_scrambled_split(monkeypatch, one_intra_op_thread):
    """Phase 3m(a) refuses an int8 tp split whose two shards project their
    heads' outputs through each other's int8 columns of the output
    projection: the goal descriptors or the teacher-forced steps disagree
    with the unsplit's."""
    from vitvs_tpu_torch.parallel import mesh as tmesh

    def swapped(self, blk, cfg, devices, _init=tmesh.TPQuantBlock.__init__):
        _init(self, blk, cfg, devices)
        a, b = self.shards[0], self.shards[1]
        a.proj_weight, b.proj_weight = b.proj_weight, a.proj_weight

    qnet, cfg, qmodel, scene, _ = _tiny_int8_tp_setup()
    monkeypatch.setattr(tmesh.TPQuantBlock, "__init__", swapped)
    with pytest.raises(AssertionError, match="int8 tp"):
        chip_smoke.run_int8_tp(qnet, cfg, qmodel, scene, episodes=[0, 1, 2, 3], num_steps=4,
                               segment_steps=2)


@pytest.mark.parametrize("shape", [(1, 37, 2, 64), (2, 65, 3, 64)])
def test_chip_smoke_bf16l_check_rejects_f32_scores(monkeypatch, shape):
    """Phase 3m(c) refuses a bf16-logits variant that leaves its roundings
    out (the exact kernel's f32 scores in its place): its mean |diff| to
    the plain version is then the exact kernel's, not at most half of it."""
    from vitvs_tpu_torch.ops import attention

    monkeypatch.setattr(attention, "mha_attention_bf16l",
                        lambda q, k, v: attention.mha_attention_plain(q, k, v))
    with pytest.raises(AssertionError, match="bf16-logits"):
        chip_smoke.check_bf16l("cpu", shapes=(shape,))
