"""The evaluation metrics the training CLI's validation reports: paired retrieval, the k-NN
angle and the modality separability probe."""
