"""Port of ``repro.data``: the synthetic LM stream."""
