"""Runtime telemetry of the port: metrics, counters and profiler spans
(torch port of ``repro.obs``).

Enable with ``obs.enable(metrics_dir=...)`` (JSONL under that directory)
or ``obs.enable(sink=...)`` / ``obs.capture()`` (in memory, tests).  While
disabled -- the default -- every record point returns before it touches
its arguments, so instrumented code dispatches no extra tensor operation
(``tests/test_torch_obs.py`` counts them).  While enabled, record points
snapshot their tensors on the device and never wait for it;
``obs.flush()`` moves the snapshots to the host and writes the records
(``repro_torch.obs.registry``).

Spans have a switch of their own: the profiler's on-flag
(``torch.autograd.profiler._is_profiler_enabled``).  While a ``torch.profiler`` records, every span is
a ``record_function`` annotation in its trace, whether obs is on or off;
otherwise every span is one shared null context that dispatches nothing.

JSONL schema (one object per line), the reference's byte for byte except
``ts``::

    {"ts": <unix float>, "metric": "<dotted.name>",
     "kind": "counter" | "gauge" | "histogram" | "event",
     "step": <int, when set_step() was called>,
     "value": <scalar or list>            # counter/gauge
     "count"/"min"/"p50"/"p90"/"max"/"sum": ...  # histogram summary
     "labels": {<labels>}}

Metrics catalog -- the record points the port has:

== Proposition 1 (co-rank search cost) ==
``corank.iterations``        histogram, per search: iterations of
                             Algorithm 1; labels ``bound = ceil(log2
                             min(m, n)) + 1`` (value <= bound), ``m``,
                             ``n``; a gauge of the fixed round count where
                             the caller fixes it.
``kway.corank_rounds``       gauge: lock-step binary-search rounds of the
                             k-way cut; labels ``bound``.

== External (out-of-core) sort ==
``external.runs_spilled``    counter: sorted runs written to host.
``external.bytes_spilled``   counter: bytes those runs occupy on disk.
``external.windows_merged``  counter: output windows made durable.
``external.merge_passes``    gauge: fanout-capped passes a sort took.
``external.device_resident_bytes`` gauge: bytes on the card right now --
                             one chunk during ``phase="chunk_sort"``, the
                             staged windows and one output window during
                             ``phase="merge"``.
``external.resident_boundary_elems`` gauge: input elements the host
                             co-rank planner materialises per probe
                             (exactly ``k``; label ``bound = k``).
``external.plan_probes``     counter: boundary probes per cut search.
``external.copy_compute_overlap`` gauge in [0, 1]: share of host staging
                             time hidden behind an in-flight device merge;
                             labels ``k``.

== Serving ==
``serve.admitted``           counter: requests moved into KV-pool slots.
``serve.completed``          counter: requests retired.
``serve.queue_depth``        gauge: requests waiting for a slot.
``serve.active_slots``       gauge: occupied slots after admission; labels
                             ``capacity``.
``serve.slots_recycled``     counter: slot ``free()`` calls.
``serve.step_latency``       gauge: wall-clock microseconds of one engine
                             step; labels ``batch``, ``unit``.
``serve.topk_merge_rounds``  gauge: merges per batched top-k call after
                             the block sort (a function of vocab and
                             fanout, never of the batch); labels
                             ``batch``, ``blocks``, ``fanout``.
``serve.topk_candidates``    counter: candidate keys entering the final
                             merge; labels ``batch``, ``k``.
``serve.sampled_tokens``     gauge, ``(batch,)``: the token ids the
                             lock-step loop drew this step (snapshotted on
                             the device); labels ``batch``.

== MoE ==
``moe.expert_load``          gauge, per dropless MoE layer: the largest
                             expert's rows over the mean (``T k / E``),
                             from the segment sizes the dispatch has
                             already read to the host; labels ``experts``,
                             ``top_k``.

== Dispatch ==
``kernels.backend_selected`` event, once per (op, backend, source): which
                             backend ``repro_torch.backend`` chose and why.
``kernels.dispatch_calls``   counter per call; labels ``op``, ``backend``.
``obs.profile_started`` / ``obs.profile_stopped`` events: the profiler's
                             trace window (``--profile-steps``).

== Spans (recorded only while a profiler records) ==
``repro.stable_merge``, ``repro.stable_merge_kway``, ``repro.merge_window``,
``repro.stable_sort`` (kernel dispatch) and ``repro.merge_kway`` sit
inside ``obs.span``; ``repro.external_sort`` and the launcher's
``serve.prefill`` inside ``obs.host_span``; each generated step of the
launchers inside ``obs.step_span("decode", i)``.  Inside a decode step,
on both serving paths (``LockstepDecoder``, ``DecodeEngine``):

``serve.decode``             one model step (``decode_step``/``_ragged``).
``serve.sample``             one step's sampling: the key hash and the
                             sampler.
``sample.topk``              a sampler's merge tournament: one
                             ``merge_topk`` a row (per-request forms) or
                             one ``batched_topk`` (batched forms).
``sample.draw``              softmax, nucleus cut, Gumbel draw, gather.
``model.embed``              embedding and rope or position tables.
``model.attn``               one layer's attention with its cache write
                             (gqa, MLA, a hybrid's shared block).
``model.ssm``                one Mamba2 layer and its state writes;
``ssm.state_write``          inside it, the conv state's copy into the
                             cache (the recurrence writes the SSM state
                             in place).
``model.mlp``                one dense FFN; ``model.moe`` one MoE layer,
                             inside it ``moe.route`` (router product and
                             top-k), ``moe.dispatch`` (assignment sort,
                             bounds, the group sizes' host read),
                             ``moe.experts`` (the expert products) and
                             ``moe.combine`` (weights, scatter, sum over
                             choices, shared experts).
``model.head``               final norm and unembedding.

Around ``serve.decode`` and ``serve.sample`` in ``DecodeEngine.step``,
its host work:

``serve.admit``              admission of queued requests and their slot
                             claims (``KVPool.alloc``).
``serve.pack``               the packed ``(4, b)`` host array of the
                             step's inputs and its copy to the device.
``serve.readback``           the blocking copy of the sampled tokens to
                             the host.
``serve.retire``             banking each slot's token, retiring finished
                             requests and freeing their slots.

== Collective traffic of a traced step ==
``hlo.collectives``          event: the collective traffic counted on a
                             traced step (``attach_hlo_report``).
``hlo.report_failed``        event: attach_hlo_report swallowed an
                             error (its type and repr).

== Distributed layer (``repro_torch.distributed``; label ``device`` = rank) ==
``splitters.pairwise_rounds`` / ``splitters.kway_rounds`` gauges: the
                             lock-step rounds of the distributed co-ranks.
``splitters.segment_cut_scalars`` counter: int32 scalars of one segment-
                             cut round (``p * (E + 1)``).
``exchange.send_lengths``, ``exchange.peer_bytes``,
``exchange.block_elements``, ``exchange.padding_slots``,
``exchange.length_skew``     gauges of one ``exchange_block``.
``moe.planned_per_source``, ``moe.recv_per_source``, ``moe.group_sizes``,
``moe.routing_skew`` gauges and ``moe.overflow`` counter (planned minus
                             received) of one dropless dispatch.
``collectives.bytes``        counter: bytes one collective delivered to
                             this rank; labels ``op``, ``dtype``,
                             ``elements``.
``collectives.host_reads``   counter: reads of a ragged exchange's split
                             sizes on the host (one an exchange).
"""

from repro_torch.obs.registry import (
    capture,
    counter,
    disable,
    enable,
    enabled,
    flush,
    gauge,
    histogram,
    log_event,
    record,
    set_step,
    totals,
)
from repro_torch.obs.sink import JsonlSink, ListSink, Sink
from repro_torch.obs.trace import (
    attach_hlo_report,
    host_span,
    span,
    start_profile,
    step_span,
    stop_profile,
)

__all__ = [
    "enable",
    "disable",
    "enabled",
    "capture",
    "record",
    "counter",
    "gauge",
    "histogram",
    "log_event",
    "set_step",
    "flush",
    "totals",
    "Sink",
    "ListSink",
    "JsonlSink",
    "span",
    "host_span",
    "step_span",
    "start_profile",
    "stop_profile",
    "attach_hlo_report",
]
