"""Host-side data for the port: tokenizer, image normalization and the PIL path, the
synthetic stream, the webdataset and file-list readers with their decode and augmentations,
the --wire-size resize, the semantic encoder and the prefetching device feed."""
