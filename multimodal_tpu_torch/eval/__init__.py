"""The evaluations: paired retrieval, the k-NN angle and the modality separability probe of
the training CLI's validation; top-k, zero-shot classification, linear probing and
captioning (BLEU)."""

from multimodal_tpu_torch.eval.captioning import CaptioningMetric, corpus_bleu, sentence_bleu
from multimodal_tpu_torch.eval.entropy import average_kth_neighbor_angle, entropy_metric
from multimodal_tpu_torch.eval.linear_probe import (
    linear_probe_metrics,
    probe_accuracy,
    train_linear_probe,
)
from multimodal_tpu_torch.eval.metadata import apply_templates, classnames, templates
from multimodal_tpu_torch.eval.retrieval import get_clip_metrics, recall_at_k
from multimodal_tpu_torch.eval.separability import linear_separability
from multimodal_tpu_torch.eval.topk import paired_ranks, top_k_score, topk_metrics
from multimodal_tpu_torch.eval.zero_shot import (
    accuracy_counts,
    build_zero_shot_classifier,
    zero_shot_eval,
)
