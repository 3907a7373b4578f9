"""Tasks: what data a CLI reads and how it batches it."""
