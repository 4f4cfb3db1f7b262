"""Models of the MMFL tasks."""
