"""The modes a cell's workload file can name (``"mode"``), one module each
with ``run(ctx) -> dict``."""
