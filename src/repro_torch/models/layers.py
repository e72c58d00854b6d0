"""Shared model building blocks (torch port of ``repro.models.layers``).

Plain functions on nested dicts of tensors, as the reference's params
pytrees: the carry-over from the reference (``models.convert``) is then a
leaf-for-leaf copy.  Each ``init_*`` takes an explicit
``torch.Generator`` and a required ``device`` keyword and returns the
params alone; the reference's second return value, the tree of logical
:class:`PartitionSpec` entries, comes from the matching ``*_specs`` function
(``transformer.param_specs`` assembles them).  TP shards the "wide" axis
on ``model``, FSDP shards the d_model axis on ``data``; ``pod`` is pure
data parallelism.

The activation constraints (``set_batch_axes``, ``constrain_batch_leading``,
``constrain_spec``) are no-ops until a launcher sets the batch axes, as in
the reference; then they redistribute a DTensor to the spec's placements
on its own mesh, and leave a plain tensor as it is.

A layer that runs on a rank's own shards of DTensor inputs (attention,
the SSD scan and step, the expert segments, the decode caches' writes)
goes through :func:`on_local_shards`, with the layout of
:func:`row_head_layout` where the work is independent per row and per
head; :func:`write_cache` writes a token's cache entries, plain or
sharded.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = [
    "PartitionSpec",
    "P",
    "spec_placements",
    "is_dtensor",
    "on_local_shards",
    "row_head_layout",
    "layout_placements",
    "shard_offset",
    "write_cache",
    "set_batch_axes",
    "get_batch_axes",
    "constrain_batch_leading",
    "constrain_spec",
    "rmsnorm_specs",
    "embedding_specs",
    "mlp_specs",
    "truncated_normal",
    "init_rmsnorm",
    "rmsnorm",
    "layernorm",
    "init_embedding",
    "embed",
    "unembed",
    "init_mlp",
    "mlp",
    "rope_frequencies",
    "apply_rope",
    "sinusoidal_positions",
]


class PartitionSpec(tuple):
    """Logical sharding of one tensor: per dimension a mesh axis name, a
    tuple of names (several mesh axes on one dimension, major first), or
    ``None`` (not sharded); missing trailing entries are ``None``.  The
    port's stand-in for ``jax.sharding.PartitionSpec``, whose entries it
    normalises alike: a one-name tuple is the name, an empty one ``None``."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return None if not e else (e[0] if len(e) == 1 else tuple(e))
            return e

        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


P = PartitionSpec


def spec_placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on every
    mesh dimension that a tensor dimension names, ``Replicate()`` on the
    rest; axis names the mesh lacks are dropped.  Several mesh axes on one
    tensor dimension shard it in mesh order (the spec's order on the
    production meshes)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        for a in axes:
            if a is not None and a in names:
                out[names.index(a)] = Shard(dim)
    return out


def is_dtensor(t) -> bool:
    """``t`` is a DTensor (a plain tensor is answered without importing
    ``torch.distributed.tensor``: the check sits on the decode path)."""
    if type(t) is torch.Tensor or not isinstance(t, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def on_local_shards(fn, mesh, args, out=None):
    """``fn`` on this rank's blocks of DTensors on ``mesh``: each of
    ``args``, ``(tensor, placements)`` pairs in ``fn``'s order, is
    redistributed to its placements (a plain tensor counts as replicated,
    ``None`` is passed on) and given local; a block aliases its DTensor's
    when the placements already match, so ``fn`` may write it in place.
    The output is wrapped on ``mesh`` with the placements ``out`` (a tuple
    of them for a tuple of outputs; ``None``: returned as it is), unchecked
    (``run_check=False``): no collective runs inside ``fn``."""
    from torch.distributed.tensor import DTensor, Replicate

    def local(t, placements):
        if t is None:
            return None
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        if tuple(t.placements) != tuple(placements):
            t = t.redistribute(mesh, placements)
        return t.to_local()

    def wrap(r, placements):
        return DTensor.from_local(r, mesh, placements, run_check=False)

    res = fn(*(local(t, p) for t, p in args))
    if out is None:
        return res
    return tuple(map(wrap, res, out)) if isinstance(out, tuple) else wrap(
        res, out)


def row_head_layout(mesh, placements, head_axis, *, heads=None, groups=1,
                    on=None) -> list:
    """The layout of work independent per row and per head, a tag a mesh
    dimension: ``"rows"`` where ``placements`` shard dim 0, else
    ``"heads"`` where they shard ``head_axis`` (given ``on``: on the mesh
    dimension named ``on``) and, given ``heads``, the heads and the B/C
    ``groups`` divide its size (one group is replicated), else ``None``."""
    from torch.distributed.tensor import Shard

    def tag(i, p):
        size = mesh.size(i)
        if p == Shard(0):
            return "rows"
        if ((mesh.mesh_dim_names[i] == on if on else p == Shard(head_axis))
                and (heads is None or heads % size == 0
                     and (groups == 1 or groups % size == 0))):
            return "heads"
        return None

    return [tag(i, p) for i, p in enumerate(placements)]


def layout_placements(tags, rows=None, heads=None) -> list:
    """Placements under :func:`row_head_layout`'s ``tags``: ``Shard(rows)``
    and ``Shard(heads)`` on the row and head dimensions (replicated where
    that dim is ``None``), ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    dims = {"rows": rows, "heads": heads}
    return [Replicate() if dims.get(t) is None else Shard(dims[t])
            for t in tags]


def shard_offset(t, dim: int) -> int:
    """First global index of this rank's even shard of the DTensor ``t``'s
    ``dim`` (mesh dimensions that shard it taken major first)."""
    from torch.distributed.tensor import Shard

    mesh = t.device_mesh
    block, ways = 0, 1
    for i, p in enumerate(t.placements):
        if p == Shard(dim):
            block = block * mesh.size(i) + mesh.get_local_rank(i)
            ways *= mesh.size(i)
    return block * (t.shape[dim] // ways)


def write_cache(bufs, values, pos, rows=None) -> None:
    """Write one token's entry of every row into each cache ``(b, max_len,
    ...)`` of ``bufs`` from the ``(b, 1, ...)`` of ``values``, in the
    cache's dtype: at the shared position ``pos`` ``(1,)``
    (``index_copy_``), or, given ``rows`` (``arange(b)``), row ``r`` at
    ``pos[r]`` (a scatter).  A DTensor cache sharded on its rows and
    positions is written on each rank's local tensor, at the rows it holds
    and the positions that fall in its slice: it never travels (DTensor
    alone would gather it)."""
    if not is_dtensor(bufs[0]):
        for buf, value in zip(bufs, values):
            if rows is None:
                buf.index_copy_(1, pos, value.to(buf.dtype))
            else:
                buf[rows, pos] = value[:, 0].to(buf.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard

    idx = (pos.full_tensor() if is_dtensor(pos) else pos).expand(
        values[0].shape[0])
    for buf, value in zip(bufs, values):
        row0, pos0 = shard_offset(buf, 0), shard_offset(buf, 1)

        def write(local, value):
            n_rows, n_pos = local.shape[:2]
            at = idx.to(local.device).long()[row0:row0 + n_rows] - pos0
            inside = ((at >= 0) & (at < n_pos)).reshape(
                -1, *(1,) * (value.dim() - 1))
            at = at.clamp(0, n_pos - 1)
            r = torch.arange(n_rows, device=local.device)
            local[r, at] = torch.where(inside, value, local[r, at])

        rows_on = [p if p == Shard(0) else Replicate() for p in buf.placements]
        on_local_shards(write, buf.device_mesh, [
            (buf, buf.placements), (value[:, 0].to(buf.dtype), rows_on)])


# Activation batch axes, set by the launcher or dry-run before a step
# (("pod", "data"), ("data",), or () for batch-1 decode).  None disables
# the activation constraints (single-process runs).
_BATCH_AXES: tuple | None = None


def set_batch_axes(ba):
    global _BATCH_AXES
    _BATCH_AXES = ba


def get_batch_axes():
    return _BATCH_AXES


def _redistribute(x, spec):
    if _BATCH_AXES is None or not is_dtensor(x):
        return x
    want = spec_placements(spec, x.device_mesh)
    if all(not p.is_partial() and p == q for p, q in zip(x.placements, want)):
        return x
    return x.redistribute(x.device_mesh, want)


def constrain_batch_leading(x):
    """Shard dim 0 over the configured batch axes (residual streams); of
    those, the leading ones whose product divides dim 0 (a microbatch
    smaller than the batch ways runs on fewer ranks: DTensor does not pad
    an uneven shard as GSPMD does)."""
    if _BATCH_AXES is None or not is_dtensor(x):
        return x
    axes, ways = [], 1
    for a in _BATCH_AXES:
        if a in x.device_mesh.mesh_dim_names:
            size = x.device_mesh.size(x.device_mesh.mesh_dim_names.index(a))
            if x.shape[0] % (ways * size):
                break
            axes.append(a)
            ways *= size
    return _redistribute(x, P(tuple(axes), *(None,) * (x.dim() - 1)))


def constrain_spec(x, *entries):
    """Explicit activation constraint (a no-op without batch axes or on a
    plain tensor)."""
    if _BATCH_AXES is None:
        return x
    return _redistribute(x, P(*entries))


def rmsnorm_specs():
    return {"scale": P(None)}


def embedding_specs():
    return {"table": P("model", "data")}  # vocab TP-sharded, d FSDP-sharded


def mlp_specs(kind: str = "swiglu"):
    s = {"w_up": P("data", "model"), "w_down": P("model", "data")}
    if kind == "swiglu":
        s["w_gate"] = P("data", "model")
    return s


# Elements drawn in float32 at a time (1 GiB): a full-width leaf is drawn
# and cast chunk by chunk, so float32 never holds more than one chunk.
DRAW_CHUNK = 1 << 28


def truncated_normal(gen: torch.Generator, shape, std: float,
                     dtype=torch.float32, *, device) -> torch.Tensor:
    """``std`` times a normal truncated to [-2, 2], drawn from ``gen``
    (which lives on ``device``) in float32 and stored in ``dtype``, at
    most :data:`DRAW_CHUNK` elements at a time."""
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for lo in range(0, flat.numel(), DRAW_CHUNK):
        n = min(DRAW_CHUNK, flat.numel() - lo)
        t = torch.empty((n,), dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        flat[lo:lo + n] = t.mul_(std)
    return out


# -- normalisation -----------------------------------------------------------


def init_rmsnorm(d: int, *, device):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS normalisation over the last axis, in float32 inside."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"]).to(x.dtype)


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Layer normalisation over the last axis with a scale and no bias
    (DBRX), in float32 inside; the same ``{"scale"}`` tree as
    :func:`rmsnorm`."""
    y = F.layer_norm(x.float(), x.shape[-1:], eps=eps)
    return (y * params["scale"]).to(x.dtype)


# -- embeddings --------------------------------------------------------------


def init_embedding(gen, vocab: int, d: int, *, device, dtype=torch.float32):
    return {"table": truncated_normal(gen, (vocab, d), 0.02, dtype,
                                      device=device)}


def embed(params, tokens: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return params["table"].to(dtype)[tokens]


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """Project activations to vocab logits (tied or untied table)."""
    return torch.einsum("bsd,vd->bsv", x, params["table"].to(x.dtype))


# -- MLP ---------------------------------------------------------------------


def init_mlp(gen, d: int, ff: int, kind: str = "swiglu", *, device,
             layers: tuple = (), dtype=torch.float32):
    """MLP weights, stored in ``dtype``; ``layers`` prepends stacked-layer
    axes to each."""
    std_in = 1.0 / math.sqrt(d)
    std_out = 1.0 / math.sqrt(ff)
    names = ("w_gate", "w_up") if kind == "swiglu" else ("w_up",)
    p = {n: truncated_normal(gen, (*layers, d, ff), std_in, dtype,
                             device=device)
         for n in names}
    p["w_down"] = truncated_normal(gen, (*layers, ff, d), std_out, dtype,
                                   device=device)
    return p


def mlp(params, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    dt = x.dtype
    if kind == "swiglu":
        g = torch.einsum("bsd,df->bsf", x, params["w_gate"].to(dt))
        u = torch.einsum("bsd,df->bsf", x, params["w_up"].to(dt))
        h = F.silu(g) * u
    else:  # jax.nn.gelu's default is the tanh approximation
        u = torch.einsum("bsd,df->bsf", x, params["w_up"].to(dt))
        h = F.gelu(u, approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, params["w_down"].to(dt))


# -- rotary embeddings -------------------------------------------------------


def rope_frequencies(head_dim: int, max_pos: int, theta: float = 1e4, *,
                     device):
    """``(cos, sin)`` tables, float32 ``(max_pos, head_dim / 2)``."""
    inv = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim))
    t = torch.arange(max_pos, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos, sin, positions) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integer.

    The split-halves convention: the first and second halves of the head
    dimension are the two coordinates each frequency rotates.
    """
    c = cos[positions][..., None, :]  # (..., seq, 1, hd/2)
    s = sin[positions][..., None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, dtype=torch.bfloat16, *,
                         device) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / (1e4 ** (dim / d))
    pe = torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)
    return pe.to(dtype)
