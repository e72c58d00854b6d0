"""Training (torch port of ``repro.train``): AdamW and its schedule, the
train step with gradient accumulation, and int8 gradient quantisation."""
