"""Training data: datasets, homographies, pair batches, prefetch."""
