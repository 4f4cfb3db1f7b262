"""Architecture configurations of the real-model task worlds (own copies
of the reference's published numbers)."""
