"""The port's command line and host I/O bridge (vitvs_tpu_torch/io_bridge/),
mirroring tests/test_cli.py: --help, the rejections in the reference's
order, the npz naming, tiny runs on the CPU (--device cpu), the weight
files --checkpoint reads, pyyaml and Pillow only where they are needed, and
the host loop's feature-failure abort."""

import sys

import numpy as np
import pytest
import torch

from vitvs_tpu.io_bridge import cli as jcli
from vitvs_tpu_torch.control.ibvs import EmaState
from vitvs_tpu_torch.harness.pipeline import ServoModel, goal_descriptors, servo_step
from vitvs_tpu_torch.io_bridge import cli, config, host_loop, images
from vitvs_tpu_torch.io_bridge.config import VSConfig
from vitvs_tpu_torch.models import vit as tvit
from vitvs_tpu_torch.models.convert import TRAINED_S518, load_exported

TINY_YAML = """\
u_max: 128
v_max: 128
f_x: 100.5
f_y: 100.5
num_pairs: 12
lambda_: 0.5
control_dt: 0.1
num_circles: 1
dino_input_size: 56
layer: 1
pinv_mode: dls
"""


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Tiny shapes run thousands of small ops: one intra-op thread each, as
    the suite's parallel workers share the machine's cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cli_help():
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"])
    assert e.value.code == 0


def test_cli_has_every_reference_flag():
    """Every flag of the reference's parser, with its default, plus --device."""
    def flags(main):
        seen = {}

        class Stop(Exception):
            pass

        def fake_parse(self, argv=None, namespace=None):
            seen.update({a.dest: a.default for a in self._actions if a.dest != "help"})
            raise Stop

        orig = __import__("argparse").ArgumentParser.parse_args
        __import__("argparse").ArgumentParser.parse_args = fake_parse
        try:
            with pytest.raises(Stop):
                main([])
        finally:
            __import__("argparse").ArgumentParser.parse_args = orig
        return seen

    ref, port = flags(jcli.main), flags(cli.main)
    assert {k: v for k, v in port.items() if k != "device"} == ref
    assert port["device"] == "cuda"
    assert cli.CLASSICAL_METHODS == jcli.CLASSICAL_METHODS


@pytest.mark.parametrize("argv", [
    ["--method", "bogus"],
    ["--method", "dino", "--int8-static"],
    ["--tp", "2"],
    ["--method", "sift", "--int8"],
    ["--method", "akaze", "--mesh"],
    ["--method", "orb", "--episodes", "1,2"],
])
def test_cli_rejects_what_the_reference_rejects(argv):
    for main in (jcli.main, cli.main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2


@pytest.mark.parametrize("argv,item", [(["--mesh"], "item 8"), (["--live", "x"], "item 1")])
def test_cli_mesh_and_live_are_not_ported(argv, item, monkeypatch):
    """--mesh / --tp (ROADMAP.md queue 1, item 8) and --live / --live-every
    (item 1), which raised before they were ported, reach run_benchmark:
    a mesh of tp cells of the CPU, the live directory and its cadence."""
    import vitvs_tpu_torch.harness.benchmark as bench

    seen = _capture(monkeypatch, bench, "run_benchmark")
    extra = ["--tp", "2"] if item == "item 8" else ["--live-every", "3"]
    cli.main(argv + extra + ["--device", "cpu"])
    if item == "item 8":
        assert seen["mesh"].shape == {"dp": 1, "tp": 2} and seen["live_dir"] is None
        assert seen["mesh"].devices == ((torch.device("cpu"),) * 2,)
    else:
        assert seen["mesh"] is None and (seen["live_dir"], seen["live_every"]) == ("x", 3)


def _capture(monkeypatch, module, name):
    seen = {}

    def fake(cfg, **kw):
        seen["cfg"] = cfg
        seen.update(kw)

        class Stats:
            convergence_rate, num_converged, num_samples = 0.0, 0, 0

        class Run:
            stats, path = Stats, None

        return Run

    monkeypatch.setattr(module, name, fake)
    return seen


def test_cli_int8_static_and_dt_threaded(monkeypatch, tmp_path):
    """--int8-static reaches run_benchmark, --control-dt overrides the
    config, and both name the npz, as in the reference; cuda by default."""
    import vitvs_tpu_torch.harness.benchmark as bench

    seen = _capture(monkeypatch, bench, "run_benchmark")
    cli.main(["--method", "dino", "--int8", "--int8-static", "--control-dt", "0.2",
              "--num-samples", "2", "--out", str(tmp_path)])
    assert seen["quantized"] and seen["int8_static"] and seen["device"] == "cuda"
    assert seen["cfg"].control_dt == 0.2 and seen["cfg"].num_samples == 2
    assert seen["config_name"] == "config_int8cal_dt0.2_n2"
    cli.main(["--num-steps", "50", "--episodes", "3,1", "--device", "cpu"])
    assert seen["config_name"] == "config_steps50_replay" and seen["episode_indices"] == [3, 1]
    assert seen["device"] == "cpu" and seen["rotation_search"]


def test_cli_classical_naming_and_abort(monkeypatch, tmp_path):
    import vitvs_tpu_torch.classical.benchmark as cbench

    seen = _capture(monkeypatch, cbench, "run_classical_benchmark")
    cli.main(["--method", "classical", "--poster", "synthetic", "--num-samples", "4",
              "--perturbation", "--device", "cpu", "--out", str(tmp_path)])
    assert seen["method"] == "sift" and seen["perturbation"] and seen["device"] == "cpu"
    assert seen["config_name"] == "config_n4_poster-synthetic"
    assert seen["cfg"].divergence_multiplier == 5.0 and seen["cfg"].early_divergence_abort
    assert seen["scene"].texture.shape == (512, 512, 3)


@pytest.mark.parametrize("method", ["harris", "dino"])
def test_cli_runs_tiny_on_the_cpu(method, tmp_path, capsys):
    """A tiny config file, the synthetic poster, 2 episodes of 3 steps on
    --device cpu: the npz is named as the reference names it."""
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_YAML)
    argv = ["--method", method, "--config", str(cfg), "--poster", "synthetic",
            "--num-samples", "2", "--num-steps", "3", "--chunk", "2", "--device", "cpu",
            "--out", str(tmp_path)]
    if method == "dino":
        argv.append("--no-rotation-search")
    assert cli.main(argv) == 0
    tag = "dino_no_rot" if method == "dino" else method
    path = tmp_path / f"results_tiny_n2_steps3_poster-synthetic_{tag}_standard.npz"
    assert path.exists()
    assert len(np.load(path, allow_pickle=True)["convergence_flags"]) == 2
    assert "convergence:" in capsys.readouterr().out


def test_cli_checkpoint_reads_exported_and_torch_hub_files(tmp_path):
    """--checkpoint: the exported npz and a torch-hub state dict give the
    same ViT; an orbax directory fails naming the export script."""
    cfg = VSConfig()
    net = cli.load_checkpoint(str(TRAINED_S518), cfg, "cpu")
    sd, _ = load_exported(TRAINED_S518)
    assert torch.equal(net.state_dict()["blocks.3.attn.qkv.weight"],
                       sd["blocks.3.attn.qkv.weight"].float())
    pth = tmp_path / "hub.pth"
    torch.save({"model": {f"module.{k}": v for k, v in net.state_dict().items()}}, pth)
    again = cli.load_checkpoint(str(pth), cfg, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(net.state_dict().values(),
                                                 again.state_dict().values()))
    with pytest.raises(ValueError, match="scripts/export_port_weights.py"):
        cli.load_checkpoint(str(tmp_path), cfg, "cpu")


def test_config_needs_pyyaml_and_round_trips(tmp_path, monkeypatch):
    cfg = VSConfig(num_samples=7, pinv_mode="dls", kv_pool=2)
    path = tmp_path / "c.yaml"
    config.save_config(cfg, path)
    assert config.load_config(path) == cfg
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="pyyaml"):
        config.load_config(path)
    with pytest.raises(ImportError, match="pyyaml"):
        cli.main(["--config", str(path), "--device", "cpu"])


def test_images_npz_without_pillow(tmp_path, monkeypatch):
    rgb = np.random.default_rng(0).random((5, 7, 3)).astype(np.float32)
    monkeypatch.setitem(sys.modules, "PIL", None)
    images.save_image(str(tmp_path / "g.npz"), rgb)
    got = images.load_goal_image(str(tmp_path / "g.npz"))
    np.testing.assert_array_equal(got, (np.clip(rgb, 0, 1) * 255).astype(np.uint8) / np.float32(255))
    with pytest.raises(ImportError, match="Pillow"):
        images.load_image(str(tmp_path / "g.png"))


def _tiny_model():
    cfg = VSConfig(u_max=96, v_max=72, f_x=75.0, f_y=75.0, dino_input_size=84, num_pairs=12,
                   layer=1, model_name="tiny", pinv_mode="dls", max_feature_failures=3)
    vcfg = tvit.ViTConfig(patch_size=14, embed_dim=96, depth=2, num_heads=3, pos_grid=5,
                          gelu_approx=True, model_name="tiny")
    model = ServoModel(vit=vcfg, cfg=cfg, compute_dtype=torch.float32, device="cpu")
    net = tvit.init_vit(vcfg, torch.Generator().manual_seed(0), device="cpu",
                        layerscale=1.0).eval()
    return net, model


class _Source:
    def __init__(self, frames, depth):
        self.frames, self.depth, self.i = frames, depth, 0

    def get_frame(self):
        f = self.frames[min(self.i, len(self.frames) - 1)]
        self.i += 1
        return f, self.depth


class _Sink:
    def __init__(self):
        self.twists = []

    def send_twist(self, twist):
        self.twists.append(np.asarray(twist))


def test_host_loop_steps_pushes_and_aborts_on_persistent_failure():
    """ServoLoop runs the servo step on each pulled frame and pushes its
    twist; make_io_servo_step is pull -> step -> push; a frame without
    features (a blank one) counts a failure, and max_feature_failures in a
    row raise as the reference controller does."""
    net, model = _tiny_model()
    rng = np.random.default_rng(3)
    goal = (rng.random((72, 96, 3)) * 255).astype(np.uint8)
    shifted = np.roll(goal, (2, 3), axis=(0, 1))
    depth = np.full((72, 96), 0.6, np.float32)
    sink = _Sink()
    loop = host_loop.ServoLoop(net, model, goal, _Source([shifted, shifted], depth), sink, seed=5)
    infos = loop.run(max_iterations=2)
    assert len(infos) == 2 == len(sink.twists) and all(i["feature_ok"] for i in infos)
    np.testing.assert_array_equal(sink.twists[-1], infos[-1]["twist"])

    gen = torch.Generator().manual_seed(5)
    gd = goal_descriptors(net, model, goal)
    want = servo_step(net, model, gd, shifted, depth, EmaState.init(device="cpu"),
                      torch.zeros(6), generator=gen)
    pushed = _Sink()
    step = host_loop.make_io_servo_step(net, model, _Source([shifted], depth).get_frame,
                                        pushed.send_twist)
    got = step(gd, EmaState.init(device="cpu"), torch.zeros(6), torch.Generator().manual_seed(5))
    assert torch.equal(got.body_twist, want.body_twist)
    np.testing.assert_array_equal(pushed.twists[0], want.body_twist.numpy())

    blank = np.zeros((72, 96, 3), np.uint8)
    loop = host_loop.ServoLoop(net, model, goal, _Source([blank], depth), _Sink())
    with pytest.raises(RuntimeError, match="Persistent feature detection failure"):
        loop.run(max_iterations=10)
    assert loop.fail_count == model.cfg.max_feature_failures
