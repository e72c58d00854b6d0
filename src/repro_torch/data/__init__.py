"""The training data pipeline (torch port of ``repro.data``)."""
