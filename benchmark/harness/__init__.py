"""The benchmark's harness: it finds a cell's configuration, traffic mix,
metrics and limits by name, drives the program through one run, and
prints the result line."""
