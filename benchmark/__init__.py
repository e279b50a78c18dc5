"""The benchmark of the PyTorch port: one cell (a configuration under a
traffic mix) run once per ``python3 -m benchmark.run`` call."""
