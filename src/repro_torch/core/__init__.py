"""Port of ``repro.core``: the compressor, the DiLoCoX round and the
adaptive controller's trainer-side parts."""
