"""One gloo rank of the SSD decode step on a DTensor cache, for
``test_torch_ssm.py`` (on the CPU, the plain in-place step stands in for
the kernel, to check the layout of each rank's shards) and
``test_torch_kernels_cuda.py`` (the kernel itself, every rank on
``cuda:0``).

Every rank draws the whole problem from one seed, keeps its own shard of
the state (rows or heads) and runs ``models.ssm.ssd_step_`` on it, with the
inputs given whole, as shards or as plain tensors.  No case needs a
collective: each rank's inputs are cut from what it holds.  The rank puts
``(rank, {case: (state equal, y within float32 summation, y's
placements, launches)})`` on the queue; a case the kernel refuses records
the error's text.
"""

from __future__ import annotations

import datetime

# (case, the state's axis sharded over the two ranks, B/C groups, inputs as
# "plain" tensors, "replicated" DTensors or DTensor "shards" like the state)
CASES = (
    ("heads g2 plain", 1, 2, "plain"),
    ("heads g1 replicated", 1, 1, "replicated"),
    ("heads g2 shards", 1, 2, "shards"),
    ("rows g2 shards", 0, 2, "shards"),
    ("rows g1 plain", 0, 1, "plain"),
    ("headdim g2 plain", 2, 2, "plain"),  # refused: the kernel owns whole rows
)
BT, H, P, N = 4, 8, 16, 16


def _problem(torch, g, seed, dev):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((BT, H, P), generator=gen)
    dt = torch.nn.functional.softplus(torch.randn((BT, H), generator=gen) - 2)
    b = torch.randn((BT, g, N), generator=gen)
    c = torch.randn((BT, g, N), generator=gen)
    a_log = torch.log(torch.linspace(1.0, 16.0, H))
    d_skip = torch.randn((H,), generator=gen)
    state = torch.randn((BT, H, P, N), generator=gen)
    return [t.to(dev) for t in (x, dt, b, c, a_log, d_skip)], state.to(dev)


def run(rank: int, world: int, port: int, device: str, queue) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

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
        out = {}
        for case, axis, g, given in CASES:
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
        queue.put((rank, out))
    finally:
        dist.destroy_process_group()



def spawn(device: str, world: int = 2) -> dict:
    """:func:`run` on ``world`` spawned ranks: ``{rank: {case: result}}``.
    Raises unless every rank reported and exited 0."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=run, args=(r, world, port, device, queue))
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
    """Every rank: each case's state shard equal to the plain step's, y
    within float32 summation of it and laid out as the state, one launch;
    the case sharded over the head dimension refused."""
    assert sorted(got) == list(range(world))
    for rank, out in got.items():
        for case, axis, _, _ in CASES:
            if axis == 2:
                assert "rows or its heads" in out[case], (rank, case, out[case])
                continue
            assert out[case] == (True, True, f"(Shard(dim={axis}),)", 1), (
                rank, case, out[case])
