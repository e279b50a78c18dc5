"""The general generators of traffic: one module per ``kind`` of traffic
file (``train``, ``serve``), each reading only the numbers in that file and
in the configuration file, so a new cell of an existing kind is data."""
