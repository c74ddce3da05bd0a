"""Data movement between stacked shards."""
