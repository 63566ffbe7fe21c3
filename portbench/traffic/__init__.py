"""Traffic kinds (modules) and mixes (JSON files of parameters)."""
