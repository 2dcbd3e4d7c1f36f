"""The command line (``vitvs_tpu/io_bridge/cli.py``), the reference's
``run_ibvs.sh --method {sift,orb,akaze,dino}``, with the simulator on the
card:

    python -m vitvs_tpu_torch.io_bridge.cli --method dino [--config f.yaml]
        [--perturbation] [--no-rotation-search] [--num-samples N]
        [--checkpoint FILE] [--out DIR] [--device cuda|cpu]

``--method dino`` runs the ViT pipeline (``harness/benchmark.py``); the
classical methods run ``classical/benchmark.py``.  Every flag of the
reference is here, with its validation and its npz naming; ``--device``
(default ``cuda``) is the port's.  ``--checkpoint`` reads a weight file
exported by ``scripts/export_port_weights.py`` (.npz) or a torch-hub state
dict (.pth); ``--config`` needs pyyaml.
"""

from __future__ import annotations

import argparse
import os
import sys

# every non-dino method runs the classical controller with its abort rule (5x
# divergence, checked every step); 'classical' aliases sift
CLASSICAL_METHODS = ("classical", "sift", "orb", "akaze", "harris")


def load_checkpoint(path: str, cfg, device):
    """The ViT of ``cfg``'s model with the weights of ``path``: an exported
    .npz (``models/convert.load_exported``) or a torch-hub file
    (``from_torch_file``).  An orbax directory is the JAX package's format:
    export it first."""
    import torch

    from vitvs_tpu_torch.harness.pipeline import ServoModel
    from vitvs_tpu_torch.models.convert import from_torch_file, load_exported
    from vitvs_tpu_torch.models.vit import ViT

    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory (an orbax checkpoint of the JAX package); "
                         f"export it for the port with scripts/export_port_weights.py "
                         f"--ckpt {path} and pass the .npz it writes")
    sd, _ = load_exported(path) if path.endswith(".npz") else from_torch_file(path, cfg.model_name)
    net = ViT.from_state_dict(ServoModel.create(cfg, device=device).vit,
                              {k: v.to(torch.float32) for k, v in sd.items()})
    return net.to(device).eval()


def main(argv=None):
    p = argparse.ArgumentParser(description="ViT-VS benchmark on the PyTorch/CUDA port")
    p.add_argument("--method", default="dino",
                   choices=["dino", *CLASSICAL_METHODS],
                   help="feature pipeline: dino = ViT descriptors; sift = DoG"
                        " scale-space + 128-d L2; orb = steered BRIEF binary;"
                        " akaze = nonlinear scale space + M-LDB binary;"
                        " harris = single-scale corner baseline"
                        " ('classical' aliases sift)")
    p.add_argument("--config", default=None, help="YAML config path (needs pyyaml)")
    p.add_argument("--perturbation", action="store_true",
                   help="per-episode perturbed poster textures")
    p.add_argument("--no-rotation-search", action="store_true")
    p.add_argument("--num-samples", type=int, default=None,
                   help="override config num_samples")
    p.add_argument("--control-dt", type=float, default=None,
                   help="override config control_dt (sim integration period"
                        " per controller iteration)")
    p.add_argument("--num-steps", type=int, default=None,
                   help="cap rollout length (default: config max_iterations)")
    p.add_argument("--checkpoint", default=None,
                   help="ViT weights: an .npz exported by scripts/export_port_weights.py,"
                        " or a torch-hub .pth state dict")
    p.add_argument("--out", default=".", help="results output directory")
    p.add_argument("--chunk", type=int, default=8, help="episodes run together")
    p.add_argument("--poster", default=None,
                   help="poster texture: an image file (.npz with an 'image' array;"
                        " other formats need Pillow), or 'synthetic' for the procedural"
                        " test poster (default: the reference's real poster on its"
                        " real geometry)")
    p.add_argument("--resume", default=None,
                   help="episode checkpoint file for crash-resumable sweeps")
    p.add_argument("--episodes", default=None,
                   help="comma-separated ABSOLUTE episode indices to replay"
                        " (e.g. '37,102,441'): the same episodes as inside the"
                        " full seed-41 sweep (dino only)")
    p.add_argument("--mesh", action="store_true",
                   help="shard rollout chunks over all devices (not ported)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree for the ViT params (with --mesh)")
    p.add_argument("--int8", action="store_true",
                   help="serve the ViT on the int8 W8A8 path instead of bf16")
    p.add_argument("--live", default=None, metavar="DIR",
                   help="live snapshots of the first in-flight episode (not ported)")
    p.add_argument("--live-every", type=int, default=1,
                   help="segments between live snapshots (default 1)")
    p.add_argument("--int8-static", action="store_true",
                   help="with --int8: static activation scales calibrated on rendered"
                        " scene views, instead of per-token dynamic scales")
    p.add_argument("--device", default="cuda",
                   help="the device the benchmark runs on (default cuda)")
    args = p.parse_args(argv)

    from vitvs_tpu_torch.io_bridge.config import VSConfig, load_config

    cfg = load_config(args.config) if args.config else VSConfig()
    if args.num_samples:
        cfg = cfg.replace(num_samples=args.num_samples)
    if args.control_dt:
        cfg = cfg.replace(control_dt=args.control_dt)
    if args.method in CLASSICAL_METHODS:
        # the classical controller's 5x divergence abort
        cfg = cfg.replace(divergence_multiplier=5.0, early_divergence_abort=True)

    # flag combinations are checked before the checkpoint loads
    if args.int8_static and not args.int8:
        p.error("--int8-static requires --int8")
    if args.tp != 1 and not args.mesh:
        p.error("--tp requires --mesh (tensor parallelism shards over the mesh)")
    if args.method != "dino" and (args.int8 or args.mesh):
        p.error(f"--int8/--mesh apply to the dino pipeline only; "
                f"--method {args.method} runs the classical controller "
                f"(f32, single-device)")
    if args.episodes and args.method != "dino":
        p.error("--episodes applies to the dino pipeline only")

    net = None
    if args.checkpoint:
        net = load_checkpoint(args.checkpoint, cfg, args.device)

    # every result-changing flag names the npz, so that a smoke run never
    # overwrites a full sweep's
    config_name = (os.path.splitext(os.path.basename(args.config))[0]
                   if args.config else "config")
    if args.int8:
        config_name += "_int8cal" if args.int8_static else "_int8"
    if args.control_dt:
        config_name += f"_dt{args.control_dt:g}"
    if args.num_samples:
        config_name += f"_n{args.num_samples}"
    if args.num_steps:
        config_name += f"_steps{args.num_steps}"
    if args.poster:
        stem = ("synthetic" if args.poster == "synthetic" else
                os.path.splitext(os.path.basename(args.poster))[0])
        config_name += f"_poster-{stem}"
    episode_indices = None
    if args.episodes:
        episode_indices = [int(s) for s in args.episodes.split(",")]
        config_name += "_replay"

    scene = None   # None: the benchmark drivers load the real poster scene
    if args.poster:
        from vitvs_tpu_torch.sim.scene import Scene, make_synthetic_poster

        if args.poster == "synthetic":
            texture = make_synthetic_poster(512, seed=0)
        else:
            from vitvs_tpu_torch.io_bridge.images import load_image

            texture = load_image(args.poster)
        scene = Scene.create(texture, device=args.device)

    if args.method == "dino":
        from vitvs_tpu_torch.harness.benchmark import run_benchmark

        run = run_benchmark(
            cfg, net=net, scene=scene, out_dir=args.out, config_name=config_name,
            perturbation=args.perturbation, rotation_search=not args.no_rotation_search,
            chunk=args.chunk, num_steps=args.num_steps, checkpoint_path=args.resume,
            mesh=True if args.mesh else None, quantized=args.int8,
            int8_static=args.int8_static, episode_indices=episode_indices,
            live_dir=args.live, device=args.device)
    else:
        from vitvs_tpu_torch.classical.benchmark import run_classical_benchmark

        run = run_classical_benchmark(
            cfg, scene=scene, out_dir=args.out, config_name=config_name,
            method=args.method if args.method != "classical" else "sift",
            perturbation=args.perturbation, chunk=args.chunk, num_steps=args.num_steps,
            checkpoint_path=args.resume, device=args.device)

    print(f"results: {run.path}")
    print(f"convergence: {run.stats.convergence_rate:.1f}% "
          f"({run.stats.num_converged}/{run.stats.num_samples})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
