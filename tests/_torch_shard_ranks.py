"""Two gloo ranks running the model layers on DTensor shards
(``models.layers.on_local_shards``), for ``test_torch_ssm.py`` (on the CPU)
and ``test_torch_kernels_cuda.py`` (the SSD decode kernel, every rank on
``cuda:0``).

Every rank draws each problem whole from one seed, runs the plain
single-process layer on it, and runs the layer again on DTensors of the two
ranks; it puts ``(rank, {case: result})`` on the queue.

* The SSD decode step (:data:`STEP_CASES`, every device): the rank keeps
  its own shard of the state (rows or heads) and runs ``ssd_step_`` on it,
  the inputs given whole, as shards or as plain tensors; no case needs a
  collective.  On the CPU the plain in-place step stands in for the kernel,
  to check the layout of each rank's shards.  A result is ``(state equal,
  y within float32 summation, y's placements, launches)``, or the error's
  text of a case the kernel refuses.
* The other layers (:data:`LAYER_CASES`, with ``layers=True``): the chunked
  scan ``ssd_chunked`` on row and head shards, the dropless expert
  segments with expert-parallel weights (``grouped_gemm`` and the MoE layer
  at dbrx's smoke width), and a decode cache's write (``write_cache``) on
  caches sharded over their positions or rows.  A result is ``(states and
  caches equal, outputs within float32 summation, placements)``.
"""

from __future__ import annotations

import datetime
import traceback

# (case, the state's axis sharded over the two ranks, B/C groups, inputs as
# "plain" tensors, "replicated" DTensors or DTensor "shards" like the state)
STEP_CASES = (
    ("heads g2 plain", 1, 2, "plain"),
    ("heads g1 replicated", 1, 1, "replicated"),
    ("heads g2 shards", 1, 2, "shards"),
    ("rows g2 shards", 0, 2, "shards"),
    ("rows g1 plain", 0, 1, "plain"),
    ("headdim g2 plain", 2, 2, "plain"),  # refused: the kernel owns whole rows
)
# case -> the placements its outputs must have
LAYER_CASES = {
    "chunked_rows_g2": "((Shard(dim=0),), (Shard(dim=0),))",
    "chunked_heads_g2": "((Shard(dim=2),), (Shard(dim=1),))",
    "chunked_heads_g1": "((Shard(dim=2),), (Shard(dim=1),))",
    "grouped_gemm_experts": "(Partial(sum),)",
    "moe_dropless_experts": "(Replicate(),)",
    "mla_cache_positions": "(Shard(dim=1),)",
    "mla_cache_rows": "(Shard(dim=0),)",
    "ragged_cache_positions": "(Shard(dim=1),)",
}
BT, S, H, P, N = 4, 8, 8, 16, 16


def _problem(torch, g, seed, dev, s=None):
    """The SSD inputs, one token (``s`` None) or ``s`` of them, and a
    state."""
    gen = torch.Generator().manual_seed(seed)
    seq = () if s is None else (s,)
    x = torch.randn((BT, *seq, H, P), generator=gen)
    dt = torch.nn.functional.softplus(
        torch.randn((BT, *seq, H), generator=gen) - 2)
    b = torch.randn((BT, *seq, g, N), generator=gen)
    c = torch.randn((BT, *seq, g, N), generator=gen)
    a_log = torch.log(torch.linspace(1.0, 16.0, H))
    d_skip = torch.randn((H,), generator=gen)
    state = torch.randn((BT, H, P, N), generator=gen)
    return [t.to(dev) for t in (x, dt, b, c, a_log, d_skip)], state.to(dev)


def _close(torch, got, want):
    """Within float32 summation: 1e-5 of the largest magnitude."""
    return bool((got - want).abs().max() <= 1e-5 * want.abs().max())


def _step_cases(torch, ssm, mesh, rank, world, dev, step, counter):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    out = {}
    for case, axis, g, given in STEP_CASES:
        args, state = _problem(torch, g, seed=axis * 10 + g, dev=dev)
        want_y, want_h = ssm.ssd_step(*args, state)
        # float32 summation error of y: 1e-5 of its terms' magnitudes
        terms = torch.einsum("bhpn,bhn->bhp", want_h.abs(),
                             args[3].abs().repeat_interleave(H // g, 1))
        mine = DTensor.from_local(state.chunk(world, axis)[rank].clone(),
                                  mesh, [Shard(axis)], run_check=False)
        if given == "replicated":
            args = [DTensor.from_local(t, mesh, [Replicate()],
                                       run_check=False) for t in args]
        elif given == "shards":
            cut = [axis, axis, axis if axis == 0 or g > 1 else None,
                   axis if axis == 0 or g > 1 else None,
                   0 if axis == 1 else None, 0 if axis == 1 else None]
            args = [t if a is None else DTensor.from_local(
                t.chunk(world, a)[rank], mesh, [Shard(a)], run_check=False)
                for t, a in zip(args, cut)]
        launches = counter.launches
        try:
            y = step(*args, mine)
        except ValueError as e:
            out[case] = str(e)
            continue
        if dev.type == "cuda":
            torch.cuda.synchronize()
        got_y, got_h = y.to_local(), mine.to_local()
        err = (got_y - want_y.chunk(world, axis)[rank]).abs()
        out[case] = (
            bool(torch.equal(got_h, want_h.chunk(world, axis)[rank])),
            bool((err <= 1e-5 * terms.chunk(world, axis)[rank]).all()),
            str(y.placements),
            counter.launches - launches,
        )
    return out


def _layer_cases(torch, mesh, rank, world):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.configs.registry import ARCHS, smoke_config
    from repro_torch.kernels.merge import register_dtensor_rules
    from repro_torch.launch.sharding import Partitioner
    from repro_torch.models import layers as L
    from repro_torch.models import moe, ssm

    def dt(t, placement, dim=None):
        local = t if dim is None else t.chunk(world, dim)[rank]
        return DTensor.from_local(local, mesh, [placement], run_check=False)

    out = {}
    # the chunked scan: x on its rows, or whole (its heads go on "model")
    for case, g, axis in (("chunked_rows_g2", 2, 0),
                          ("chunked_heads_g2", 2, None),
                          ("chunked_heads_g1", 1, None)):
        args, h0 = _problem(torch, g, seed=30 + g, dev="cpu", s=S)
        want_y, want_h = ssm.ssd_chunked(*args, chunk=4, h0=h0)
        x = (dt(args[0], Shard(0), 0) if axis == 0
             else dt(args[0], Replicate()))
        y, h = ssm.ssd_chunked(x, *args[1:], chunk=4, h0=h0)
        y_dim, h_dim = (0, 0) if axis == 0 else (2, 1)
        out[case] = (
            bool(torch.equal(h.to_local(), want_h.chunk(world, h_dim)[rank])),
            _close(torch, y.to_local(), want_y.chunk(world, y_dim)[rank]),
            str((y.placements, h.placements)))

    # the expert segments: each rank multiplies its own experts' rows
    gen = torch.Generator().manual_seed(40)
    x = torch.randn((24, 16), generator=gen)
    w = torch.randn((4, 16, 8), generator=gen)
    sizes = torch.tensor([5, 0, 11, 6], dtype=torch.int32)
    want = moe.grouped_gemm(x, w, sizes)
    got = moe.grouped_gemm(x, dt(w, Shard(0), 0), sizes)
    out["grouped_gemm_experts"] = (
        True, _close(torch, got.full_tensor(), want), str(got.placements))

    # the MoE layer at dbrx's smoke width, experts on "model", under the
    # partitioner the sharded steps run in (the router's top-k and the
    # dispatch sort have no DTensor strategy of their own)
    cfg = smoke_config(ARCHS["dbrx-132b"])
    params = moe.init_moe(torch.Generator().manual_seed(41), cfg.d_model,
                          cfg.moe_ff, cfg.n_experts, device="cpu")
    xs = torch.randn((2, 3, cfg.d_model), generator=gen)
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.moe_top_k,
              capacity_factor=cfg.capacity_factor,
              scoring=cfg.router_scoring, dispatch="dropless")
    want = moe.moe_apply(params, xs, **kw)
    specs = moe.moe_specs()
    sharded = {n: DTensor.from_local(
        t.chunk(world, 0)[rank] if L.spec_placements(specs[n], mesh)[0]
        == Shard(0) else t, mesh, L.spec_placements(specs[n], mesh),
        run_check=False) for n, t in params.items()}
    register_dtensor_rules()
    with Partitioner():
        got = moe.moe_apply(sharded, dt(xs, Replicate()), **kw)
    got = got.redistribute(mesh, [Replicate()])
    out["moe_dropless_experts"] = (
        True, _close(torch, got.to_local(), want), str(got.placements))

    # a decode cache's token write: MLA's latent and rope key at the
    # lock-step position, then a GQA k and v at per-row positions
    gen = torch.Generator().manual_seed(42)
    for case, axis, shapes, pos, rows in (
            ("mla_cache_positions", 1, ((16,), (8,)), torch.tensor([5]), None),
            ("mla_cache_rows", 0, ((16,), (8,)), torch.tensor([2]), None),
            ("ragged_cache_positions", 1, ((2, 4), (2, 4)),
             torch.tensor([1, 6, 3, 7]), torch.arange(BT))):
        bufs = [torch.randn((BT, 8, *shape), generator=gen)
                for shape in shapes]
        values = [torch.randn((BT, 1, *shape), generator=gen)
                  for shape in shapes]
        mine = [dt(b.clone(), Shard(axis), axis) for b in bufs]
        L.write_cache(mine, values, pos, rows)
        L.write_cache(bufs, values, pos, rows)
        out[case] = (
            all(torch.equal(m.to_local(), b.chunk(world, axis)[rank])
                for m, b in zip(mine, bufs)),
            True, str(mine[0].placements))
    return out


def run(rank: int, world: int, port: int, device: str, layers: bool,
        queue) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels import ssd as kssd
    from repro_torch.models import ssm

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        dev = torch.device(device)
        mesh = init_device_mesh(dev.type, (world,), mesh_dim_names=("model",))
        if dev.type == "cpu":
            # ssd_step_ takes the kernel only for shards on the card: call
            # its DTensor route with the plain in-place step in its place.
            def plain(*args):
                y, h_new = ssm.ssd_step(*args)
                args[-1].copy_(h_new)
                plain.launches += 1
                return y

            plain.launches = 0
            ssm.ssd_step_update = plain
            step, counter = ssm._ssd_step_on_local_shards, plain
        else:
            step, counter = ssm.ssd_step_, kssd.ssd_step_update
        try:
            out = _step_cases(torch, ssm, mesh, rank, world, dev, step,
                              counter)
            if layers:
                out.update(_layer_cases(torch, mesh, rank, world))
        except Exception:  # reported, so the test fails at once
            out = traceback.format_exc()
        queue.put((rank, out))
    finally:
        dist.destroy_process_group()


def spawn(device: str, world: int = 2, layers: bool = False) -> dict:
    """:func:`run` on ``world`` spawned ranks: ``{rank: {case: result}}``
    (``layers``: the layer cases too).  Raises unless every rank reported
    and exited 0."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=run,
                         args=(r, world, port, device, layers, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        got = dict(queue.get(timeout=240) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise AssertionError(f"ranks exited {codes}")
    return got


def check(got: dict, world: int = 2) -> None:
    """The step cases on every rank: each case's state shard equal to the
    plain step's, y within float32 summation of it and laid out as the
    state, one launch; the case sharded over the head dimension refused."""
    assert sorted(got) == list(range(world))
    for rank, out in got.items():
        assert isinstance(out, dict), (rank, out)
        for case, axis, _, _ in STEP_CASES:
            if axis == 2:
                assert "rows or its heads" in out[case], (rank, case, out[case])
                continue
            assert out[case] == (True, True, f"(Shard(dim={axis}),)", 1), (
                rank, case, out[case])


def check_layer(got: dict, case: str, world: int = 2) -> None:
    """One layer case on every rank: states and caches equal to the plain
    layer's, outputs within float32 summation of it, laid out as
    :data:`LAYER_CASES` says."""
    assert sorted(got) == list(range(world))
    for rank, out in got.items():
        assert isinstance(out, dict), (rank, out)
        assert out[case] == (True, True, LAYER_CASES[case]), (
            rank, case, out[case])
