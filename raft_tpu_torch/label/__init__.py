"""Label utilities (counterpart of ``raft_tpu/label/``): monotonic
relabeling and label merging."""

from raft_tpu_torch.label.classlabels import get_classes, make_monotonic, merge_labels

__all__ = ["get_classes", "make_monotonic", "merge_labels"]
