"""Model configurations (torch port of ``repro.configs``): the port's own
copies of the reference's ``ModelConfig`` and architecture files."""
