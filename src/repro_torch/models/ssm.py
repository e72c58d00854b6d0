"""Mamba2 (SSD, state-space duality) block (torch port of
``repro.models.ssm``).

Prefill and training use the chunked block decomposition of the Mamba2
paper (:func:`ssd_chunked`): the sequence is cut into chunks of length L;
within a chunk the SSD dual form is an (L x L) masked product, across
chunks a loop carries the (heads, head_dim, d_state) state.  Decode is the
O(1) recurrence on a carried state (:func:`ssd_step`), which the reference
computes as ``ssd_chunked`` at ``s = chunk = 1``; the one-token form is
the same function in a handful of ops, where the chunked form at length 1
issues about thirty (masks and cumsums of 1 x 1), and the eager decode step
pays for every launch on the host.  The decode step itself calls
:func:`mamba2_decode_`, which writes a layer's cached states in place: on
the card the recurrence is one kernel (``kernels/csrc/ssd_step.cu``) that
reads and writes the float32 state once, elsewhere :func:`ssd_step` and a
copy.  DTensors run on each rank's own rows and heads
(``layers.on_local_shards`` on ``layers.row_head_layout``).

Casts follow the reference step for step (a tolerance does not absorb a
reordering): the gated norm multiplies by ``silu(z)`` in the compute dtype
before its float32 norm; the scan runs in float32, ``y`` is cast to the
input dtype and only then gets the D skip, itself cast to the input dtype;
``dt = softplus(dt + dt_bias)`` in float32; the SSM state is float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from repro_torch import obs
from repro_torch.kernels.ssd import ssd_step_update
from repro_torch.models.layers import (
    P,
    is_dtensor,
    layout_placements,
    on_local_shards,
    row_head_layout,
    truncated_normal,
)

__all__ = [
    "init_mamba2",
    "mamba2_specs",
    "mamba2_forward",
    "mamba2_decode_",
    "ssd_chunked",
    "ssd_step",
    "ssd_step_",
]


def init_mamba2(gen: torch.Generator, d: int, *, expand: int = 2,
                headdim: int = 64, d_state: int = 128, ngroups: int = 1,
                d_conv: int = 4, device, layers: tuple = (),
                dtype=torch.float32):
    """Mamba2 weights and their ``meta``: the matrices drawn from ``gen``
    into ``dtype``, the vectors float32 as in the reference; ``layers``
    prepends stacked-layer axes to each (``dt_bias`` is drawn per layer)."""
    d_inner = expand * d
    nheads = d_inner // headdim
    conv_dim = d_inner + 2 * ngroups * d_state
    f32 = dict(dtype=torch.float32, device=device)

    def per_layer(v):
        return v.expand(*layers, *v.shape).clone()

    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((*layers, nheads), generator=gen, **f32) * (hi - lo) + lo
    p = {
        # fused input projection: [x, z, B, C, dt]
        "w_in": truncated_normal(
            gen, (*layers, d, d_inner * 2 + 2 * ngroups * d_state + nheads),
            1.0 / math.sqrt(d), dtype, device=device),
        "conv_w": truncated_normal(gen, (*layers, d_conv, conv_dim), 0.1,
                                   dtype, device=device),
        "conv_b": torch.zeros((*layers, conv_dim), **f32),
        "A_log": per_layer(torch.log(torch.linspace(1.0, 16.0, nheads, **f32))),
        "D": torch.ones((*layers, nheads), **f32),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))),
        "norm_scale": torch.ones((*layers, d_inner), **f32),
        "w_out": truncated_normal(gen, (*layers, d_inner, d),
                                  1.0 / math.sqrt(d_inner), dtype,
                                  device=device),
    }
    meta = dict(d_inner=d_inner, nheads=nheads, d_state=d_state,
                ngroups=ngroups, d_conv=d_conv, headdim=headdim,
                conv_dim=conv_dim)
    return p, meta


def mamba2_specs():
    """Logical specs of :func:`init_mamba2`'s params."""
    return {"w_in": P("data", "model"), "conv_w": P(None, "model"),
            "conv_b": P("model"), "A_log": P("model"), "D": P("model"),
            "dt_bias": P("model"), "norm_scale": P("model"),
            "w_out": P("model", "data")}


def _split_in(proj, meta):
    d_inner = meta["d_inner"]
    gs = meta["ngroups"] * meta["d_state"]
    x = proj[..., :d_inner]
    z = proj[..., d_inner:2 * d_inner]
    b = proj[..., 2 * d_inner:2 * d_inner + gs]
    c = proj[..., 2 * d_inner + gs:2 * d_inner + 2 * gs]
    dt = proj[..., 2 * d_inner + 2 * gs:]
    return x, z, b, c, dt


def _causal_conv(x, w, bias, state=None):
    """Depthwise causal conv along the sequence.  x: (b, s, ch), w: (k, ch).

    With ``state`` (b, k-1, ch) the conv continues from a decode state.
    Returns ``(silu(y), new_state)``; the new state is the last k-1 inputs
    in ``x``'s dtype."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s, :] * w[i].to(x.dtype) for i in range(k))
    y = y + bias.to(x.dtype)
    return F.silu(y), xp[:, -(k - 1):, :]


def _gated_rmsnorm(x, z, scale, eps: float = 1e-6):
    x = x * F.silu(z.float()).to(x.dtype)
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _d_skip(y, x, d_skip):
    """``y + D * x``, the product in float32 cast to ``x``'s dtype first
    (a bf16 add in a bf16 run, as in the reference)."""
    return y + (d_skip.float()[:, None] * x.float()).to(x.dtype)


def ssd_chunked(x, dt, b, c, a_log, d_skip, meta=None, *, chunk: int = 128,
                h0=None):
    """SSD forward.  x: (bt, s, h, p); dt: (bt, s, h); b/c: (bt, s, g, n).

    Returns ``(y, h_last)``, ``y`` in ``x``'s dtype and ``h_last``
    (bt, h, p, n) float32.  ``h0`` continues from a state.  Each chunk's
    work (the L x L masked-decay product) happens inside the chunk loop,
    so live memory is O(L^2) per head, not O(S*L).
    """
    if is_dtensor(x):
        return _ssd_on_local_heads(x, dt, b, c, a_log, d_skip, meta,
                                   chunk=chunk, h0=h0)
    bt, s, h, pdim = x.shape
    g, n = b.shape[2], b.shape[3]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    hg = h // g  # heads per B/C group
    dev = x.device
    a = -torch.exp(a_log.float())  # (h,) negative decay rates
    tri = (torch.arange(chunk, device=dev)[:, None]
           >= torch.arange(chunk, device=dev)[None, :])
    if h0 is None:
        h0 = torch.zeros((bt, h, pdim, n), dtype=torch.float32, device=dev)
    hprev = h0.float().reshape(bt, g, hg, pdim, n)
    ys = []
    for lo in range(0, s, chunk):
        xc = x[:, lo:lo + chunk].float()
        dtc = dt[:, lo:lo + chunk].float()
        bc = b[:, lo:lo + chunk].float()
        cc = c[:, lo:lo + chunk].float()
        l = dtc * a  # (bt, L, h) log decays
        cs = torch.cumsum(l, dim=1)  # inclusive within-chunk cumulative
        # intra-chunk masked decay: exp(cs[t] - cs[tau]) for t >= tau
        seg = cs[:, :, None, :] - cs[:, None, :, :]  # (bt, L, L, h)
        m = torch.where(tri[None, :, :, None], torch.exp(seg),
                        torch.zeros((), device=dev))
        mh = m.permute(0, 3, 1, 2).reshape(bt, g, hg, chunk, chunk)
        scores = torch.einsum("blgn,bmgn->bglm", cc, bc)
        scores = scores.reshape(bt, g, 1, chunk, chunk)
        dtx = xc * dtc[..., None]  # (bt, L, h, p)
        dtxg = dtx.reshape(bt, chunk, g, hg, pdim)
        y_intra = torch.einsum("bghlm,bmghp->blghp", scores * mh, dtxg)
        # inter-chunk: the carried state's contribution
        decay_in = torch.exp(cs).reshape(bt, chunk, g, hg)
        y_inter = torch.einsum("blgn,bghpn,blgh->blghp", cc, hprev, decay_in)
        # state update
        decay_tail = torch.exp(cs[:, -1:, :] - cs).reshape(bt, chunk, g, hg)
        hc = torch.einsum("blgn,blghp,blgh->bghpn", bc, dtxg, decay_tail)
        chunk_decay = torch.exp(cs[:, -1, :]).reshape(bt, g, hg)
        hprev = hprev * chunk_decay[..., None, None] + hc
        ys.append((y_intra + y_inter).reshape(bt, chunk, h, pdim)
                  .to(x.dtype))
    y = _d_skip(torch.cat(ys, dim=1), x, d_skip)
    return y, hprev.reshape(bt, h, pdim, n)


def _ssd_on_shards(fn, mesh, tags, head_axis, args, with_state):
    """``fn(x, dt, B, C, A_log, D, state)`` on each rank's rows and heads
    of ``tags`` (a ``row_head_layout``): x and dt with their heads on
    ``head_axis``, B and C with their groups (one group replicated for
    all), A_log and D on the heads, the state on its rows and heads.
    Returns y laid out as x (and the state's layout, ``with_state``)."""
    g = args[2].shape[head_axis]
    seq = layout_placements(tags, 0, head_axis)
    grp = layout_placements(tags, 0, head_axis if g > 1 else None)
    vec = layout_placements(tags, None, 0)
    state = layout_placements(tags, 0, 1)
    return on_local_shards(
        fn, mesh, zip(args, (seq, seq, grp, grp, vec, vec, state)),
        (seq, state) if with_state else seq)


def _ssd_on_local_heads(x, dt, b, c, a_log, d_skip, meta, *, chunk, h0):
    """:func:`ssd_chunked` on DTensors, run on each rank's batch rows and
    heads: the heads shard over the ``model`` axis (where the reference's
    specs put ``A_log``, ``D`` and ``dt_bias``) when they divide it."""
    mesh, g = x.device_mesh, b.shape[2]
    tags = row_head_layout(mesh, x.placements, 2, heads=x.shape[2], groups=g,
                           on="model")
    return _ssd_on_shards(
        lambda *t: ssd_chunked(*t[:6], meta, chunk=chunk, h0=t[6]), mesh,
        tags, 2, (x, dt, b, c, a_log, d_skip, h0), True)


def ssd_step(x, dt, b, c, a_log, d_skip, h0):
    """One token of the SSD recurrence.  x: (bt, h, p); dt: (bt, h)
    (after the softplus); b/c: (bt, g, n); h0: (bt, h, p, n) float32.

    ``h' = exp(dt * a) * h + dt * x (outer) B`` and ``y = C . h' + D * x``,
    in float32 with ``y`` cast to ``x``'s dtype before the D skip.  Returns
    ``(y (bt, h, p), h')``; the same function as ``ssd_chunked`` at
    ``s = chunk = 1``.
    """
    bt, h, pdim = x.shape
    g, n = b.shape[1], b.shape[2]
    a = -torch.exp(a_log.float())
    dtf = dt.float()
    bh = b.float().repeat_interleave(h // g, dim=1)  # (bt, h, n)
    ch = c.float().repeat_interleave(h // g, dim=1)
    dtx = x.float() * dtf[..., None]  # (bt, h, p)
    hnew = (h0.float() * torch.exp(dtf * a)[..., None, None]
            + dtx[..., None] * bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", hnew, ch).to(x.dtype)
    return _d_skip(y, x, d_skip), hnew


def ssd_step_(x, dt, b, c, a_log, d_skip, state):
    """:func:`ssd_step` with the new state written into ``state`` (bt, h,
    p, n) float32 in place; returns ``y``.  A state on the card takes the
    kernel (:func:`repro_torch.kernels.ssd.ssd_step_update`), which reads
    and writes it once and raises on what it does not take: a plain CUDA
    tensor directly, a DTensor whose shards are on the card on each rank's
    own rows and heads (:func:`_ssd_step_on_local_shards`).  CPU and fake
    tensors run :func:`ssd_step` and copy its state back, with the same
    bits.  Counts ``kernels.dispatch_calls`` (``op="ssd_step"``,
    ``backend`` ``cuda`` or ``torch``) while obs is on."""
    sharded = type(state) is not torch.Tensor and is_dtensor(state)
    on_card = (state.is_cuda and (type(state) is torch.Tensor
                                  or sharded and not is_fake(state)))
    if obs.enabled():
        obs.counter("kernels.dispatch_calls", 1, op="ssd_step",
                    backend="cuda" if on_card else "torch")
    if on_card:
        if sharded:
            return _ssd_step_on_local_shards(x, dt, b, c, a_log, d_skip,
                                             state)
        return ssd_step_update(x, dt, b, c, a_log, d_skip, state)
    y, h_new = ssd_step(x, dt, b, c, a_log, d_skip, state)
    state.copy_(h_new)
    return y


def _ssd_step_on_local_shards(x, dt, b, c, a_log, d_skip, state):
    """The kernel on a DTensor state: each rank writes its own shard of
    the state in place, from inputs laid out as that shard.  The state may
    be sharded over rows (axis 0) and heads (axis 1, when they and the
    groups divide the mesh axis); the kernel is per row and per head, so
    no collective runs inside it.  Returns ``y`` as a DTensor laid out as
    the state's rows and heads."""
    from torch.distributed.tensor import Replicate

    mesh, g = state.device_mesh, b.shape[1]
    tags = row_head_layout(mesh, state.placements, 1, heads=x.shape[1],
                           groups=g)
    for i, (t, p) in enumerate(zip(tags, state.placements)):
        if t is None and p != Replicate():
            raise ValueError(
                f"ssd_step: the kernel takes a state sharded over its rows or "
                f"its heads (dividing {mesh.size(i)} with its {g} groups), "
                f"got {state.placements} on {mesh}")
    return _ssd_on_shards(ssd_step_update, mesh, tags, 1,
                          (x, dt, b, c, a_log, d_skip, state), False)


def _mix_in(params, meta, x, conv_state):
    """The block up to the scan: the input projection, the causal conv
    (continued from ``conv_state``, or from zeros) and ``dt``'s softplus.
    Returns ``(x, z, B, C, dt, new_conv_state)``, each with its sequence
    axis."""
    proj = torch.einsum("bsd,de->bse", x, params["w_in"].to(x.dtype))
    xs, z, b, c, dt = _split_in(proj, meta)
    conv_in = torch.cat([xs, b, c], dim=-1)
    conv_out, new_conv_state = _causal_conv(
        conv_in, params["conv_w"], params["conv_b"], conv_state)
    d_inner = meta["d_inner"]
    gs = meta["ngroups"] * meta["d_state"]
    xs = conv_out[..., :d_inner]
    b = conv_out[..., d_inner:d_inner + gs]
    c = conv_out[..., d_inner + gs:]
    dt = F.softplus(dt.float() + params["dt_bias"])  # (bt, s, h)
    return xs, z, b, c, dt, new_conv_state


def _mix_out(params, meta, y, z):
    """The block after the scan: the gated norm and the output
    projection.  y: the scan's output in ``z``'s dtype, any shape that
    holds (bt, s, d_inner)."""
    bt, s = z.shape[:2]
    y = _gated_rmsnorm(y.reshape(bt, s, meta["d_inner"]), z,
                       params["norm_scale"])
    return torch.einsum("bse,ed->bsd", y, params["w_out"].to(z.dtype))


def _one_token(meta, xs, dt, b, c):
    """The scan's inputs of a one-token call, shaped for :func:`ssd_step`."""
    bt = xs.shape[0]
    h, pdim = meta["nheads"], meta["headdim"]
    g, n = meta["ngroups"], meta["d_state"]
    return (xs.reshape(bt, h, pdim), dt[:, 0], b.reshape(bt, g, n),
            c.reshape(bt, g, n))


def mamba2_forward(params, meta, x, *, chunk: int = 128):
    """The Mamba2 block over a sequence (training and prefill).  x: (b, s,
    d).  Returns ``(out, None)``, as the reference's call without a state
    does; the one-token form, which writes a decode step's cached states,
    is :func:`mamba2_decode_`."""
    bt, s, _ = x.shape
    xs, z, b, c, dt, _ = _mix_in(params, meta, x, None)
    h, pdim = meta["nheads"], meta["headdim"]
    g, n = meta["ngroups"], meta["d_state"]
    y, _ = ssd_chunked(
        xs.reshape(bt, s, h, pdim), dt, b.reshape(bt, s, g, n),
        c.reshape(bt, s, g, n), params["A_log"], params["D"], meta,
        chunk=chunk)
    return _mix_out(params, meta, y, z), None


def mamba2_decode_(params, meta, x, conv_state, ssm_state):
    """One token of the Mamba2 block (x: (b, 1, d)) that overwrites the
    layer's cached states in place: ``conv_state`` (b, d_conv-1,
    conv_dim) with the conv's new window (inside the ``ssm.state_write``
    span) and ``ssm_state`` (b, h, p, n) float32 by :func:`ssd_step_`.
    Returns the block's output; on the CPU, bit for bit the block's
    output and states computed with :func:`ssd_step` on new tensors; on
    the card the output's scan sums in another order (a float32
    rounding)."""
    xs, z, b, c, dt, new_conv_state = _mix_in(params, meta, x, conv_state)
    with obs.span("ssm.state_write"):
        conv_state.copy_(new_conv_state)
    y = ssd_step_(*_one_token(meta, xs, dt, b, c), params["A_log"],
                  params["D"], ssm_state)
    return _mix_out(params, meta, y, z)
