"""Port of ``repro.train``: the single-host DiLoCoX trainer and its
quickstart driver."""
