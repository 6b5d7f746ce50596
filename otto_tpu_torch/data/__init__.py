from otto_tpu_torch.data.events import EventStore, PackedSessions
from otto_tpu_torch.data.labels import SessionLabels, build_labels, random_cutoffs
from otto_tpu_torch.data.synthetic import synthetic_events
from otto_tpu_torch.data import splits, submission

__all__ = [
    "EventStore",
    "PackedSessions",
    "SessionLabels",
    "build_labels",
    "random_cutoffs",
    "synthetic_events",
    "splits",
    "submission",
]
