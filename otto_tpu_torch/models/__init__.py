"""Models (port of ``otto_tpu/models``): SGNS inference and the
embedding-kNN recommender, frequency statistics, the aid-weight baseline,
covisitation construction and the covisitation heuristic, the candidate
generators and GBDT inference."""

from otto_tpu_torch.models.candidates import (
    CandidateSet,
    covisit_candidates,
    embedding_candidates,
    recency_candidates,
    regular_candidates,
)
from otto_tpu_torch.models.covisitation import (
    CovisitationMatrices,
    build_covisitation,
    covisit_heuristic_predictions,
    session_unique_counts,
)
from otto_tpu_torch.models.embeddings import SGNSModel, embedding_knn_predictions
from otto_tpu_torch.models.frequency import FrequencyStatistics, aid_frequency_predictions
from otto_tpu_torch.models.gbdt import GBDTForest, GBDTRankerModel, load_ranker_model
from otto_tpu_torch.models.recency import aid_weight_predictions
