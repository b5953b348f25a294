"""Port subpackage: see the package docstring of repro_torch."""
