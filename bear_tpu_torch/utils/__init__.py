"""Model directories, run configs, metrics and device resolution."""
