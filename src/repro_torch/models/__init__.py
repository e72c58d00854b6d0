"""Model layers (torch port of ``repro.models``): every family's
parameters, the training and prefill forward, and the decode steps."""
