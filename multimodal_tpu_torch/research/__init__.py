"""The research toolkit: vMF mixture EM, the GMM model-selection study, embedding
projections, the figures and the loss-dynamics bench (port of ``multimodal_tpu/research``)."""

from multimodal_tpu_torch.research.gmm_fit import gmm_model_selection
from multimodal_tpu_torch.research.projection import pca_projection, project_embeddings
from multimodal_tpu_torch.research.vmf_mixture import (
    VMFMixtureEM,
    fit_von_mises_fisher_mixture,
    solve_concentration,
)

__all__ = ["VMFMixtureEM", "fit_von_mises_fisher_mixture", "gmm_model_selection",
           "pca_projection", "project_embeddings", "solve_concentration"]
