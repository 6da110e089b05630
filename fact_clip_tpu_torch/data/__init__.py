"""The data path: file IO, the dataset registry, bucketed batches, the
prefetcher and the synthetic fixture writers."""
