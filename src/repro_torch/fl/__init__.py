"""Experiment builders and the ``run_experiment`` entry point."""
