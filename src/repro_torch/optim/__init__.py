"""Port of ``repro.optim``: inner AdamW, outer Nesterov, schedules."""
