"""Host-side data for the port: tokenizer, image normalization, the synthetic stream, the
semantic encoder and the prefetching device feed."""
