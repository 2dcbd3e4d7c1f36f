"""A (dp, tp) grid of devices for batched multi-episode evaluation
(``vitvs_tpu/parallel/mesh.py``).

The JAX package shards the benchmark's vmapped chunk over a
``jax.sharding.Mesh`` from one controller.  Here one process drives a
(dp, tp) grid of ``torch.device``s, and a cell of the grid may repeat a
device (tests use ``[cpu] * 8``; one card ``[cuda:0] * 4``), so the split's
arithmetic runs on any number of cards:

* **dp**: a chunk's episodes split into ``dp`` consecutive shares, one a
  row, each run on its row's first device; results are gathered back in
  episode order, and every episode draws from its own generator seeded from
  its absolute index, so a dp-only mesh gives what one device gives;
* **tp**: the ViT's blocks split across a row's devices in the Megatron
  layout of the JAX package's ``shard_vit_params``: the qkv projection by
  head, the attention's output projection by its input, the FFN's first
  product by its output (SwiGLU: matching slices of both halves, so that
  ``silu(x1) * x2`` stays on its shard) and its second by its input.  The
  partial outputs of the two input-split products are summed on the row's
  first device in shard order and their bias is added once; the norms,
  LayerScale, the embedding and the final norm stay whole on the first
  device.  Every step of the split is an autograd operation (device copies
  and sums), so training runs on it too.
* **tp, int8** (``TPQuantViT``): the int8 serving ViT (``models/quant.py``,
  calibrated unsplit) split alike.  The qkv and fc1 products' rows go to
  their shards with their per-column weight scales and biases, so a shard's
  qkv output is [q | k | v] of its heads and runs attention over them in
  every int8 mode ('fused': one kernel launch a shard on its column
  slices).  The proj and fc2 products split by input columns: each shard
  returns its int32 accumulator, the accumulators are summed in int32 on
  the row's first device in shard order and the epilogue (activation and
  weight scales, bias) runs once there, as GSPMD all-reduces the JAX
  package's int32 ``dot_general``.  A dynamic per-token activation scale of
  a split input comes from the whole row's maximum: the shards' (B, T, 1)
  maxima meet on the first device (a max), which sends it back, and every
  shard quantizes its columns against it.  Integer sums and maxima are
  exact, so the split gives the unsplit int8 ViT's results bit for bit.

Heads or FFN widths that ``tp`` does not divide raise ``ValueError``, as
the JAX package's ``device_put`` does on its 8-device CPU mesh.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Sequence

import torch
from torch import nn

from vitvs_tpu_torch.control.ibvs import EmaState
from vitvs_tpu_torch.harness.pipeline import ServoModel, StepResult, servo_step
from vitvs_tpu_torch.harness.rollout import EpisodeResult, rollout_episode
from vitvs_tpu_torch.models.quant import (QuantBlock, QuantLinear, QuantViT, act_amax,
                                          int8_product, q_epilogue, quant_attention)
from vitvs_tpu_torch.models.vit import (Block, ViT, ViTConfig, _layernorm, attend,
                                        attention_probs, ffn_activation, qkv_heads)
from vitvs_tpu_torch.sim.scene import Scene


def _device(d) -> torch.device:
    """``d`` as a torch.device with its index (``cuda`` is the current card)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, tp) grid of devices: ``devices[r]`` is dp row r's tp shards."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": len(self.devices), "tp": len(self.devices[0])}

    @property
    def first(self) -> torch.device:
        """Where results are gathered: row 0's first device."""
        return self.devices[0][0]

    def distinct(self) -> list[torch.device]:
        """Each device of the grid once, in grid order."""
        return list(dict.fromkeys(d for row in self.devices for d in row))


def make_mesh(n_devices: int | None = None, tp: int = 1, devices=None) -> Mesh:
    """(dp, tp) mesh over the first ``n_devices`` of ``devices`` (default:
    every visible card); a device may be listed more than once."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    n = n_devices or len(devices)
    if not 1 <= n <= len(devices):
        raise ValueError(f"a mesh of {n} devices from a list of {len(devices)}")
    if tp < 1 or n % tp:
        raise ValueError(f"{n} devices not divisible by tp={tp}")
    return Mesh(tuple(tuple(devices[r * tp:(r + 1) * tp]) for r in range(n // tp)))


def to_device(tree: Any, device) -> Any:
    """``tree`` (tensors, modules, NamedTuples, lists, tuples and dicts of
    them) on ``device``; a module already there is returned as it is, one
    elsewhere is copied."""
    device = _device(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, nn.Module):
        p = next(tree.parameters(), next(tree.buffers(), None))
        if p is None or p.device == device:
            return tree
        return copy.deepcopy(tree).to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(x, device) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(x, device) for x in tree)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree


def replicate(tree: Any, mesh: Mesh) -> dict[torch.device, Any]:
    """One copy of ``tree`` on each distinct device of the mesh."""
    return {d: to_device(tree, d) for d in mesh.distinct()}


def _linear(weight: torch.Tensor, bias: torch.Tensor | None) -> nn.Linear:
    """An nn.Linear holding copies of ``weight`` (out, in) and ``bias``."""
    lin = nn.Linear(weight.shape[1], weight.shape[0], bias=bias is not None, device="meta")
    lin.weight = nn.Parameter(weight.detach().clone())
    if bias is not None:
        lin.bias = nn.Parameter(bias.detach().clone())
    return lin


class BlockShard(nn.Module):
    """Shard ``s`` of ``tp`` of a block: the qkv rows of its heads, the
    output projection's columns for them (no bias), the FFN's first product's
    rows of its hidden slice (SwiGLU: that slice of x1 and of x2, in that
    order) and the second product's columns for it (no bias)."""

    def __init__(self, blk: Block, s: int, tp: int):
        super().__init__()
        cfg = blk.attn.cfg
        self.cfg = cfg
        self.heads = cfg.num_heads // tp
        D, n = cfg.embed_dim, cfg.num_heads // tp * cfg.head_dim
        rows = torch.cat([torch.arange(c * D + s * n, c * D + (s + 1) * n) for c in range(3)])
        qkv = blk.attn.qkv
        self.qkv = _linear(qkv.weight[rows], None if qkv.bias is None else qkv.bias[rows])
        self.proj = _linear(blk.attn.proj.weight[:, s * n:(s + 1) * n], None)
        fc1, fc2 = blk.mlp.linears()
        H = cfg.hidden_dim
        m = H // tp
        hid = torch.arange(s * m, (s + 1) * m)
        if cfg.ffn == "swiglu":
            hid = torch.cat([hid, hid + H])
        self.fc1 = _linear(fc1.weight[hid], fc1.bias[hid])
        self.fc2 = _linear(fc2.weight[:, s * m:(s + 1) * m], None)

    def attention(self, x_norm: torch.Tensor, use_kernels: bool) -> torch.Tensor:
        """This shard's partial of the attention's output projection."""
        return self.proj(attend(self.cfg, self.qkv, self.heads, x_norm, use_kernels))

    def ffn(self, x_norm: torch.Tensor) -> torch.Tensor:
        """This shard's partial of the FFN's output."""
        return self.fc2(ffn_activation(self.fc1(x_norm), self.cfg))

    def qkv_heads(self, x_norm: torch.Tensor) -> torch.Tensor:
        return qkv_heads(self.qkv, x_norm, self.heads, self.cfg.head_dim)


class TPBlock(nn.Module):
    """A block split over ``devices`` (one :class:`BlockShard` each); the
    norms, LayerScale and the two summed products' biases on the first."""

    def __init__(self, blk: Block, devices: Sequence[torch.device]):
        super().__init__()
        dev0, tp = devices[0], len(devices)
        for name in ("norm1", "ls1", "norm2", "ls2"):
            setattr(self, name, copy.deepcopy(getattr(blk, name)).to(dev0))
        self.proj_bias = nn.Parameter(blk.attn.proj.bias.detach().clone().to(dev0))
        self.ffn_bias = nn.Parameter(blk.mlp.linears()[1].bias.detach().clone().to(dev0))
        self.shards = nn.ModuleList(BlockShard(blk, s, tp).to(d) for s, d in enumerate(devices))

    def _scatter(self, x: torch.Tensor):
        return [(sh, x.to(sh.qkv.weight.device)) for sh in self.shards]

    @staticmethod
    def _reduce(parts: list[torch.Tensor], device: torch.device) -> torch.Tensor:
        """The partial outputs summed on ``device`` in shard order."""
        out = parts[0].to(device)
        for p in parts[1:]:
            out = out + p.to(device)
        return out

    def forward(self, x: torch.Tensor, use_kernels: bool, facet: str | None = None) -> torch.Tensor:
        """:meth:`vitvs_tpu_torch.models.vit.Block.forward` on the split."""
        dev0 = x.device
        f32 = self.shards[0].cfg.ln_f32
        xn = _layernorm(x, self.norm1, f32)
        if facet is not None:
            qkv = torch.cat([sh.qkv_heads(xs).to(dev0) for sh, xs in self._scatter(xn)],
                            dim=3).transpose(2, 3)                    # (3, B, h, T, hd)
            if facet == "attn":
                return attention_probs(qkv[0], qkv[1])
            return qkv[("query", "key", "value").index(facet)]
        attn = self._reduce([sh.attention(xs, use_kernels) for sh, xs in self._scatter(xn)], dev0)
        x = x + self.ls1.gamma * (attn + self.proj_bias)
        xn = _layernorm(x, self.norm2, f32)
        ffn = self._reduce([sh.ffn(xs) for sh, xs in self._scatter(xn)], dev0)
        return x + self.ls2.gamma * (ffn + self.ffn_bias)


class TPViT(ViT):
    """A ViT whose blocks are split over ``devices`` (:class:`TPBlock`); the
    embedding and the final norm whole on the first device.  It is a ViT:
    ``vit_features``, ``vit_forward``, the extractor, the facets and the
    training forward take it as they take the unsplit one.  Int8
    calibration (``models/quant.py``) refuses it."""

    def __init__(self, net: ViT, devices: Sequence[torch.device]):
        nn.Module.__init__(self)      # not ViT.__init__, which would build whole blocks
        cfg = net.cfg
        _check_tp(cfg, len(devices))
        dev0 = devices[0]
        self.cfg = cfg
        self.devices = tuple(devices)
        self.patch_embed = copy.deepcopy(net.patch_embed).to(dev0)
        self.cls_token = nn.Parameter(net.cls_token.detach().clone().to(dev0))
        self.pos_embed = nn.Parameter(net.pos_embed.detach().clone().to(dev0))
        self.blocks = nn.ModuleList(TPBlock(b, devices) for b in net.blocks)
        self.norm = None if net.norm is None else copy.deepcopy(net.norm).to(dev0)
        self.train(net.training)

    def merged(self, part=lambda p: p) -> dict[str, torch.Tensor]:
        """The unsplit ViT's state dict (names as ``ViT.state_dict``) built
        from ``part(p)`` of each parameter p (``lambda p: p.grad``: the
        gradients), on the first device."""
        dev0 = self.devices[0]
        g = lambda p: part(p).detach().to(dev0)                     # noqa: E731
        out = {n: g(p) for n, p in self.named_parameters() if not n.startswith("blocks.")}
        swiglu = self.cfg.ffn == "swiglu"
        for i, blk in enumerate(self.blocks):
            pre = f"blocks.{i}."
            for name in ("norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias",
                         "ls1.gamma", "ls2.gamma"):
                out[pre + name] = g(blk.get_parameter(name))
            sh = blk.shards
            qkv = [g(s.qkv.weight).reshape(3, -1, s.qkv.weight.shape[1]) for s in sh]
            out[pre + "attn.qkv.weight"] = torch.cat(qkv, 1).flatten(0, 1)
            if sh[0].qkv.bias is not None:
                out[pre + "attn.qkv.bias"] = torch.cat([g(s.qkv.bias).reshape(3, -1)
                                                        for s in sh], 1).flatten()
            out[pre + "attn.proj.weight"] = torch.cat([g(s.proj.weight) for s in sh], 1)
            out[pre + "attn.proj.bias"] = g(blk.proj_bias)
            fc1, fc2 = ("mlp.w12", "mlp.w3") if swiglu else ("mlp.fc1", "mlp.fc2")
            for what in ("weight", "bias"):
                parts = [g(getattr(s.fc1, what)) for s in sh]
                if swiglu:                            # each shard's [x1 slice; x2 slice]
                    halves = [p.chunk(2, 0) for p in parts]
                    parts = [h[0] for h in halves] + [h[1] for h in halves]
                out[f"{pre}{fc1}.{what}"] = torch.cat(parts, 0)
            out[pre + fc2 + ".weight"] = torch.cat([g(s.fc2.weight) for s in sh], 1)
            out[pre + fc2 + ".bias"] = g(blk.ffn_bias)
        return out


def _check_tp(cfg: ViTConfig, tp: int) -> None:
    if cfg.num_heads % tp:
        raise ValueError(f"{cfg.num_heads} heads are not divisible by tp={tp}")
    if cfg.hidden_dim % tp:
        raise ValueError(f"an FFN {cfg.hidden_dim} wide is not divisible by tp={tp}")


def _quant_rows(lin: QuantLinear, rows: torch.Tensor) -> QuantLinear:
    """A QuantLinear of ``lin``'s output rows ``rows`` with their weight
    scales and biases."""
    return QuantLinear(lin.weight[rows].t(), lin.scale[rows], lin.bias[rows])


class QuantBlockShard(nn.Module):
    """Shard ``s`` of ``tp`` of an int8 block: the qkv product's rows of its
    heads and the fc1 product's rows of its hidden slice (SwiGLU: that slice
    of x1 and of x2, in that order), each with its weight scales and bias;
    the proj and fc2 products' int8 columns for them (their scales and
    biases stay with the whole block); the static activation scales whole."""

    def __init__(self, blk: QuantBlock, cfg: ViTConfig, s: int, tp: int):
        super().__init__()
        self.heads = cfg.num_heads // tp
        D, n = cfg.embed_dim, cfg.num_heads // tp * cfg.head_dim
        self.qkv = _quant_rows(blk.qkv, torch.cat([torch.arange(c * D + s * n, c * D + (s + 1) * n)
                                                   for c in range(3)]))
        H = cfg.hidden_dim
        m = H // tp
        hid = torch.arange(s * m, (s + 1) * m)
        if cfg.ffn == "swiglu":
            hid = torch.cat([hid, hid + H])
        self.fc1 = _quant_rows(blk.fc1, hid)
        self.register_buffer("proj_weight", blk.proj.weight[:, s * n:(s + 1) * n].contiguous())
        self.register_buffer("fc2_weight", blk.fc2.weight[:, s * m:(s + 1) * m].contiguous())
        self.register_buffer("act_scales", None if blk.act_scales is None
                             else blk.act_scales.clone())

    act = QuantBlock.act

    def attention(self, x_norm: torch.Tensor, cfg: ViTConfig, use_kernels: bool) -> torch.Tensor:
        """This shard's heads' attention, (B, T, heads * hd)."""
        return quant_attention(x_norm, self.qkv, self.act(0), cfg, self.heads, use_kernels)

    def ffn_hidden(self, x_norm: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
        """This shard's slice of the FFN's activation (the fc2 input)."""
        return ffn_activation(self.fc1(x_norm, self.act(1)), cfg)


class TPQuantBlock(nn.Module):
    """An int8 block split over ``devices`` (one :class:`QuantBlockShard`
    each); the norms, LayerScale and the proj and fc2 epilogues (weight
    scales, biases) on the first."""

    def __init__(self, blk: QuantBlock, cfg: ViTConfig, devices: Sequence[torch.device]):
        super().__init__()
        dev0, tp = devices[0], len(devices)
        self.eps = blk.eps
        for name in ("norm1_scale", "norm1_bias", "norm2_scale", "norm2_bias", "ls1", "ls2",
                     "act_scales"):
            t = getattr(blk, name)
            self.register_buffer(name, None if t is None else t.clone().to(dev0))
        for name in ("proj", "fc2"):
            lin = getattr(blk, name)
            self.register_buffer(name + "_scale", lin.scale.clone().to(dev0))
            self.register_buffer(name + "_bias", lin.bias.clone().to(dev0))
        self.shards = nn.ModuleList(QuantBlockShard(blk, cfg, s, tp).to(d)
                                    for s, d in enumerate(devices))

    act, norm1, norm2 = QuantBlock.act, QuantBlock.norm1, QuantBlock.norm2

    def _scatter(self, x: torch.Tensor):
        return [(sh, x.to(sh.proj_weight.device)) for sh in self.shards]

    def _product(self, parts: list[torch.Tensor], name: str, i: int,
                 out_dtype: torch.dtype) -> torch.Tensor:
        """The int8 product ``name`` ('proj' or 'fc2', activation scale
        ``i``) of the input whose columns ``parts`` hold, shard by shard: the
        shards' int32 accumulators summed on the first device in shard order,
        then the epilogue once."""
        dev0 = self.ls1.device
        amax = None
        if self.act(i) is None:          # the whole row's maxima, for every shard
            for p in parts:
                a = act_amax(p).to(dev0)
                amax = a if amax is None else torch.maximum(amax, a)
        acc = x_scale = None
        for sh, p in zip(self.shards, parts):
            a, sc = int8_product(p, getattr(sh, name + "_weight"), sh.act(i),
                                 None if amax is None else amax.to(p.device))
            acc = a.to(dev0) if acc is None else acc + a.to(dev0)
            x_scale = sc.to(dev0) if x_scale is None else x_scale
        return q_epilogue(acc, x_scale, getattr(self, name + "_scale"),
                          getattr(self, name + "_bias"), out_dtype)

    def forward(self, x: torch.Tensor, cfg: ViTConfig, use_kernels: bool) -> torch.Tensor:
        """:func:`vitvs_tpu_torch.models.quant._block_q` on the split."""
        attn = [sh.attention(xs, cfg, use_kernels).to(x.dtype)
                for sh, xs in self._scatter(self.norm1(x, cfg.ln_f32))]
        x = x + self.ls1 * self._product(attn, "proj", 2, x.dtype)
        mid = [sh.ffn_hidden(xs, cfg) for sh, xs in self._scatter(self.norm2(x, cfg.ln_f32))]
        return x + self.ls2 * self._product(mid, "fc2", 3, x.dtype)

    def qkv_heads(self, x: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
        """The shards' int8 qkv projections of the normed x (B, T, D),
        gathered on the first device -> (3, B, h, T, hd)."""
        B, T, _ = x.shape
        parts = [sh.qkv(xs, sh.act(0)).to(x.device).reshape(B, T, 3, sh.heads, cfg.head_dim)
                 for sh, xs in self._scatter(self.norm1(x, cfg.ln_f32))]
        return torch.cat(parts, dim=3).permute(2, 0, 3, 1, 4)


class TPQuantViT(QuantViT):
    """An int8 serving ViT whose blocks are split over ``devices``
    (:class:`TPQuantBlock`); the embedding whole on the first device.  It
    is a QuantViT: ``vit_features_quant`` (every facet), the servo step and
    the benchmark take it as they take the unsplit one.  Calibrate the
    unsplit float ViT, quantize it, then split."""

    def __init__(self, qnet: QuantViT, devices: Sequence[torch.device]):
        nn.Module.__init__(self)      # not QuantViT.__init__, which would build whole blocks
        cfg = qnet.cfg
        _check_tp(cfg, len(devices))
        dev0 = devices[0]
        self.cfg = cfg
        self.devices = tuple(devices)
        for name in ("patch_weight", "patch_bias", "cls_token", "pos_embed"):
            self.register_buffer(name, getattr(qnet, name).clone().to(dev0))
        self.blocks = nn.ModuleList(TPQuantBlock(b, cfg, devices) for b in qnet.blocks)


def _row_net(net, devices: tuple[torch.device, ...]):
    if len(devices) == 1:
        return to_device(net, devices[0])
    if isinstance(net, (TPViT, TPQuantViT)):
        raise ValueError(f"{type(net).__name__} is split already: split the unsplit ViT")
    if isinstance(net, QuantViT):
        return TPQuantViT(net, devices)
    if not isinstance(net, ViT):
        raise ValueError(f"tp > 1 splits a ViT or an int8 QuantViT; got {type(net).__name__}")
    return TPViT(net, devices)


def shard_vit_params(net, mesh: Mesh) -> list:
    """The net of each dp row: split over the row's devices in the Megatron
    layout when tp > 1 (:class:`TPViT`, the int8 :class:`TPQuantViT`), else
    a copy on the row's device (rows on the same devices share one)."""
    made: dict[tuple[torch.device, ...], Any] = {}
    for row in mesh.devices:
        if row not in made:
            made[row] = _row_net(net, row)
    return [made[row] for row in mesh.devices]


def row_slices(n: int, dp: int) -> list[slice]:
    """dp row r's consecutive share of a chunk of ``n`` episodes."""
    if n % dp:
        raise ValueError(f"a chunk of {n} episodes does not split over dp={dp}")
    per = n // dp
    return [slice(r * per, (r + 1) * per) for r in range(dp)]


def row_models(model: ServoModel, mesh: Mesh) -> list[ServoModel]:
    """``model`` on each dp row's first device."""
    return [dataclasses.replace(model, device=str(row[0])) for row in mesh.devices]


def _cat_on(parts, device):
    """Nests of NamedTuples of tensors concatenated on their leading axis, on
    ``device``."""
    if isinstance(parts[0], tuple):
        return type(parts[0])(*(_cat_on([p[i] for p in parts], device)
                                for i in range(len(parts[0]))))
    return torch.cat([p.to(device) for p in parts])


def batch_servo_step(net, model: ServoModel, mesh: Mesh):
    """Batched servo step with episodes split over dp (and the ViT over tp).

    Returns fn(goal_desc (t, d), rgb (B, H, W, 3), depth (B, H, W), ema
    (EmaState of (B, 6), (B,)), prev_v (B, 6), scores (B, t)) -> the
    StepResult batch on the mesh's first device.  The goal is the one the
    episodes share (the JAX function takes one per episode; the benchmark
    broadcasts one); each row matches its share against it in one launch."""
    nets = shard_vit_params(net, mesh)
    models = row_models(model, mesh)

    def step(goal_desc, rgb, depth, ema: EmaState, prev_v, scores) -> StepResult:
        outs = []
        for r, sl in enumerate(row_slices(len(rgb), mesh.shape["dp"])):
            dev = models[r].device
            outs.append(servo_step(nets[r], models[r], to_device(goal_desc, dev),
                                   to_device(rgb[sl], dev), to_device(depth[sl], dev),
                                   to_device(EmaState(ema.value[sl], ema.initialized[sl]), dev),
                                   to_device(prev_v[sl], dev), scores=to_device(scores[sl], dev)))
        return _cat_on(outs, mesh.first)

    return step


def sharded_batch_rollout(net, model: ServoModel, scene: Scene, mesh: Mesh,
                          num_steps: int | None = None):
    """Closed-loop rollouts with episodes split over dp (and the ViT over tp).

    Returns fn(goal_desc, starts (B, 3), quats (B, 4), generators (B of
    them, one per episode on its row's device, or None)) -> the
    EpisodeResult batch on the mesh's first device."""
    nets = shard_vit_params(net, mesh)
    models = row_models(model, mesh)
    scenes = replicate(scene, mesh)

    def run(goal_desc, starts, quats, generators=None) -> EpisodeResult:
        outs = []
        for r, sl in enumerate(row_slices(len(starts), mesh.shape["dp"])):
            dev = _device(models[r].device)
            outs.append(rollout_episode(
                nets[r], models[r], scenes[dev], to_device(goal_desc, dev),
                to_device(starts[sl], dev), to_device(quats[sl], dev),
                generator=None if generators is None else list(generators[sl]),
                num_steps=num_steps))
        return _cat_on(outs, mesh.first)

    return run
