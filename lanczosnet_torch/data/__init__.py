"""Graph sources and label statistics."""
