"""See the sibling modules."""
