"""Host-side data: audio IO, tokenizer, pipeline stages, dataset, prefetch."""
