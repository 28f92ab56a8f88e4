"""Shared model plumbing: logical-axis sharding, parameter factory, norms,
rotary embeddings, softplus, gated MLP, cross-entropy.

Sharding is expressed against *logical* axes ("batch", "heads", "ffn",
"experts", "vocab", "seq", ...). A :class:`ShardingRules` object maps them
to mesh axes. The parameter factory turns each leaf's logical axes into its
PartitionSpec (:func:`init_param_tree` and ``spec_mode``), and under a mesh
draws each leaf whole and keeps this rank's shard of it. The reference's
``shard`` is a GSPMD constraint; here the model runs on rank-local tensors
and places its collectives itself (tensor parallelism over ``model``:
:func:`axis_group` names the group), so :func:`shard` only checks a
tensor's rank-local shape against what its spec implies, and is a no-op
outside :func:`sharding_ctx`.

Sequence parallelism (the rule ``seq -> model`` that the reference's
``--seq-shard`` installs) is read only where the reference constrains the
residual stream, the training trunks and the encoder: they take
:func:`seq_split`'s group and pass it down to the blocks they call, which
then take this rank's rows through :func:`enter` / :func:`leave` (a gather
in, a reduce-scatter out) where they would take the whole sequence through
``copy_to`` / ``reduce_from``. The blocks never read the rule themselves:
serving's prefill shares them and runs whole, as in the reference.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import (Callable, Dict, Mapping, Optional, Sequence, Tuple,
                    Union)

import torch
import torch.nn.functional as F

from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import NamedSharding, P, entry_axes

AxisName = Union[str, Tuple[str, ...], None]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
#: the most elements a normal leaf draws in one f32 temporary (1 GiB)
SLAB_ELEMS = 2 ** 28


def torch_dtype(name: str) -> torch.dtype:
    """A config's ``dtype`` string as a ``torch.dtype``."""
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; known: "
                         f"{sorted(DTYPES)}") from None


@dataclass(frozen=True)
class ShardingRules:
    """Logical-axis -> mesh-axis mapping."""
    rules: Mapping[str, AxisName]

    def mesh_axes(self, logical: Sequence[Optional[str]]) -> P:
        return P(*[self.rules.get(ax) if ax else None for ax in logical])


def default_rules(multi_pod: bool = False) -> ShardingRules:
    """The production mapping. "batch" covers (pod, data) when the pod
    axis exists; launch code installs the right variant."""
    batch = ("pod", "data") if multi_pod else ("data",)
    return ShardingRules(rules={
        "batch": batch,
        "seq": None,           # sequence unsharded at baseline
        "seq_moe": "model",    # token axis sharded over model pre-dispatch
        "heads": "model",
        "kv_heads": "model",
        "ffn": "model",
        "experts": "model",
        "vocab": "model",
        "dmodel": None,
        "lru": "model",
        "state": None,
        "kv_seq": "model",     # decode-cache sequence sharding
        "expert_ff": None,     # 2D expert sharding for serving
    })


class _Ctx(threading.local):
    rules: Optional[ShardingRules] = None
    mesh = None


_CTX = _Ctx()


@contextlib.contextmanager
def sharding_ctx(rules: Optional[ShardingRules], mesh=None):
    """Install ``rules`` and ``mesh`` for the model code run inside (this
    thread's): the parameter factory, :func:`shard` and the model's
    collectives read them."""
    prev_r, prev_m = _CTX.rules, _CTX.mesh
    _CTX.rules, _CTX.mesh = rules, mesh
    try:
        yield
    finally:
        _CTX.rules, _CTX.mesh = prev_r, prev_m


def current_rules() -> Optional[ShardingRules]:
    return _CTX.rules


def current_mesh():
    return _CTX.mesh


def axis_group(logical: str):
    """The process group over the mesh axes ``logical`` maps to under the
    installed rules and mesh, when they hold two or more ranks; else
    ``None`` (no mesh, an unmapped axis, or one rank)."""
    if axis_size(logical) < 2:
        return None
    return _CTX.mesh.group(entry_axes(_CTX.rules.rules.get(logical)))


def axis_size(logical: str) -> int:
    """Ranks the installed rules and mesh split ``logical`` over (1 without
    them)."""
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None or rules is None:
        return 1
    axes = entry_axes(rules.rules.get(logical))
    return mesh.axis_size(axes) if axes else 1


def seq_split(S: int):
    """The group the rule ``seq`` splits the residual stream's ``S``
    positions over (sequence parallelism, the reference's ``--seq-shard``:
    ``seq -> model``), ``None`` where it splits nothing. Raises
    ``ValueError`` naming ``S`` and the axis where ``S`` does not split
    into equal chunks: nothing is padded."""
    grp = axis_group("seq")
    n = coll.size(grp)
    if S % n:
        axes = entry_axes(_CTX.rules.rules.get("seq"))
        raise ValueError(f"a sequence of {S} positions does not split over "
                         f"the {n} ranks of {axes} that the rule 'seq' maps "
                         f"it to")
    return grp


def enter(x: torch.Tensor, grp, seq=None) -> torch.Tensor:
    """A block's input ``x [B, S, d]`` as its ranks over ``grp`` (heads,
    ffn columns, channels) read it: whole, through ``copy_to`` (Megatron's
    f). Under a sequence split (``seq``, the same ranks as ``grp``) ``x``
    is this rank's rows and is gathered whole along dim 1 with
    ``gather_to`` (its partial gradient reduce-scattered back onto the
    rows); where the block is replicated (``grp`` ``None``) with
    ``gather_from``, since its gradient is whole already."""
    if seq is None:
        return coll.copy_to(x, grp)
    return (coll.gather_from(x, 1, seq) if grp is None
            else coll.gather_to(x, 1, seq))


def leave(y: torch.Tensor, grp, seq=None) -> torch.Tensor:
    """A block's output ``y [B, S, d]``, partial sums over ``grp``, summed
    (``reduce_from``, Megatron's g). Under a sequence split, summed and
    cut to this rank's rows along dim 1 (``reduce_scatter_from``); a
    replicated block's whole output is only cut (``split_to``)."""
    if seq is None:
        return coll.reduce_from(y, grp)
    return (coll.split_to(y, 1, seq) if grp is None
            else coll.reduce_scatter_from(y, 1, seq))


def shard(x: torch.Tensor, *logical: Optional[str],
          full: Optional[Sequence[Optional[int]]] = None) -> torch.Tensor:
    """``x`` as it is. Inside :func:`sharding_ctx`, ``x``'s rank-local
    shape is checked against the spec the rules give ``logical`` (trailing
    dims replicated): each dim whose global length ``full[i]`` is known
    must hold ``full[i]`` over the product of its spec's axis sizes; a spec
    naming an axis the mesh lacks raises too. No-op outside the context."""
    rules, mesh = _CTX.rules, _CTX.mesh
    if rules is None or mesh is None:
        return x
    spec = rules.mesh_axes(list(logical) + [None] * (x.ndim - len(logical)))
    for a in (a for e in spec for a in entry_axes(e)):
        if a not in mesh.shape:
            raise ValueError(f"spec {spec} names axis {a!r}, not one of "
                             f"the mesh's {mesh.axis_names}")
    for i, n in enumerate(full or ()):
        k = math.prod(mesh.shape[a] for a in entry_axes(spec[i]))
        if n is not None and (n % k or x.shape[i] != n // k):
            raise ValueError(f"a tensor of local shape {tuple(x.shape)} "
                             f"does not hold global {tuple(full)} under "
                             f"spec {spec} on {mesh}")
    return x


class ParamMaker:
    """``mk(name, shape, axes, scale, init)`` leaf constructor: every normal
    leaf is drawn in f32 from ``generator`` on ``device``, scaled, and cast
    to ``dtype`` (the reference draws the same way from its own key; the two
    generators give different numbers, so parity tests hand the reference's
    parameters over through :mod:`repro_torch.convert`). A leaf is drawn in
    slabs of at most :data:`SLAB_ELEMS` elements along its first axis, so
    that the f32 temporary stays one slab (a full-width expert tensor would
    need 15 GB of it); a leaf that fits is one draw.

    ``axes`` are the leaf's logical axes, one per dim. With ``spec_mode``
    the factory returns the leaf's PartitionSpec under ``rules`` instead of
    a tensor; with ``mesh`` it draws each leaf whole, in the same order on
    every rank, and keeps this rank's shard of it (so the shards of every
    mesh cut the same parameters from the same seed). On the ``meta``
    device it allocates nothing and draws nothing."""

    def __init__(self, generator: Optional[torch.Generator], dtype: str,
                 device: Optional[torch.device] = None, *,
                 spec_mode: bool = False,
                 rules: Optional[ShardingRules] = None, mesh=None):
        self._gen = generator
        self._dtype = torch_dtype(dtype)
        self._device = device
        self._spec_mode = spec_mode
        self._rules = rules or default_rules()
        self._mesh = mesh

    def __call__(self, name: str, shape: Tuple[int, ...],
                 axes: Optional[Tuple[Optional[str], ...]] = None,
                 scale: Optional[float] = None,
                 init: str = "normal") -> Union[torch.Tensor, P]:
        if axes is not None and len(axes) != len(shape):
            raise ValueError(f"{name}: {len(axes)} axes for shape {shape}")
        if self._spec_mode or self._mesh is not None:
            if axes is None:
                raise ValueError(f"{name}: a spec needs the leaf's axes")
            spec = self._rules.mesh_axes(axes)
            if self._spec_mode:
                return spec
        leaf = self._draw(shape, scale, init)
        if self._mesh is not None:
            leaf = NamedSharding(self._mesh, spec).shard(leaf)
        return leaf

    def _draw(self, shape, scale, init) -> torch.Tensor:
        kw = dict(dtype=self._dtype, device=self._device)
        if self._device is not None and torch.device(
                self._device).type == "meta":
            return torch.empty(shape, **kw)
        if init == "zeros":
            return torch.zeros(shape, **kw)
        if init == "ones":
            return torch.ones(shape, **kw)
        if scale is None:
            scale = shape[0] ** -0.5 if len(shape) > 1 else 0.02
        out = torch.empty(shape, **kw)
        step = max(1, SLAB_ELEMS // max(1, math.prod(shape[1:])))
        for i in range(0, shape[0], step):
            rows = min(step, shape[0] - i)
            slab = torch.randn((rows,) + tuple(shape[1:]), generator=self._gen,
                               device=self._device, dtype=torch.float32)
            out[i:i + rows] = slab.mul_(scale)
        return out


def init_param_tree(build: Callable[[ParamMaker], Dict],
                    generator: Optional[torch.Generator], dtype: str,
                    device=None, rules: Optional[ShardingRules] = None,
                    mesh=None):
    """Run ``build`` twice: once for tensors (this rank's shards under
    ``mesh``), once for PartitionSpecs."""
    params = build(ParamMaker(generator, dtype, device, rules=rules,
                              mesh=mesh))
    specs = build(ParamMaker(None, dtype, spec_mode=True, rules=rules))
    return params, specs


# ---------------------------------------------------------------------------
# Norms / rotary / MLP
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """f32 inside, cast back to ``x``'s dtype, then ``* gamma``."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * gamma


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-rotation RoPE. x: [..., seq, heads, head_dim]; positions:
    [..., seq]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)            # [hd/2]
    ang = positions[..., :, None].float() * freqs       # [..., s, hd/2]
    cos = torch.cos(ang)[..., :, None, :]               # [..., s, 1, hd/2]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it,
    ``logaddexp(x, 0)``, at every ``x`` (``F.softplus`` returns ``x``
    itself above its threshold)."""
    return torch.logaddexp(x, x.new_zeros(()))


def conv_tail(x_raw: torch.Tensor, k: int) -> torch.Tensor:
    """The last ``k - 1`` rows of ``x_raw [B, S, C]`` along the sequence,
    left-padded with zeros when ``S < k - 1``: the rolling window a
    recurrent block's causal conv of width ``k`` decodes from after a
    prefill."""
    S = x_raw.shape[1]
    if S >= k - 1:
        return x_raw[:, S - (k - 1):]
    return F.pad(x_raw, (0, 0, k - 1 - S, 0))


def gated_mlp_params(mk: ParamMaker, prefix: str, d: int, ff: int,
                     d_axis: str = "dmodel", ff_axis: str = "ffn") -> Dict:
    return {
        "wi": mk(f"{prefix}.wi", (d, ff), (d_axis, ff_axis)),
        "wg": mk(f"{prefix}.wg", (d, ff), (d_axis, ff_axis)),
        "wo": mk(f"{prefix}.wo", (ff, d), (ff_axis, d_axis)),
    }


def gated_mlp(p: Dict, x: torch.Tensor, act: str = "silu",
              seq=None) -> torch.Tensor:
    """``(x W_i * act(x W_g)) W_o``. Under a mesh that splits ``ffn`` over
    two or more ranks, each rank holds a slice of the ffn columns: ``x``
    enters through :func:`~repro_torch.parallel.collectives.copy_to` and
    the partial outputs are summed with
    :func:`~repro_torch.parallel.collectives.reduce_from` (Megatron's
    column- then row-parallel pair). ``seq``: ``x`` is this rank's rows of
    a sequence split over that group, gathered on the way in and
    reduce-scattered on the way out (:func:`enter`, :func:`leave`)."""
    grp = axis_group("ffn")
    x = enter(x, grp, seq)
    a = x @ p["wi"]
    g = x @ p["wg"]
    # jax.nn.gelu defaults to the tanh approximation; F.gelu does not
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return leave((a * g) @ p["wo"], grp, seq)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """Mean CE over valid labels (label = -1 masks; padded vocab excluded by
    construction because labels never index the pad region)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp(labels, min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return torch.sum((logz - gold) * mask) / torch.clamp(mask.sum(), min=1.0)
