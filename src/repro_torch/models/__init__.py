"""Model layers and the decode path (torch port of ``repro.models``): the
dense GQA transformer's parameters and its continuous-batching decode
step.  MLA, SSM, MoE, prefill and training are not ported yet."""
