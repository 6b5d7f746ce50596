"""Models (port of ``otto_tpu/models``): SGNS training and inference, the
embedding-kNN and session-embedding recommenders, frequency statistics, the aid-weight baseline,
covisitation construction and the covisitation heuristic, the candidate
generators, GBDT training and inference, the listwise tower ranker, the
TF-IDF recommender, the sequence recommenders (GRU, NARM, STAMP, Caser, the
transformer with dense or mixture-of-experts FFNs), matrix factorization and
collaborative filtering, and the file ensemble."""

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
from otto_tpu_torch.models.embeddings import (
    SessionEmbeddingModel,
    SGNSModel,
    embedding_knn_predictions,
    session_embeddings,
    train_sgns,
    train_sgns_device,
)
from otto_tpu_torch.models.frequency import FrequencyStatistics, aid_frequency_predictions
from otto_tpu_torch.models.gbdt import GBDTForest, GBDTRankerModel, load_ranker_model
from otto_tpu_torch.models.matrix_factorization import CFModel, MFModel, train_cf, train_mf
from otto_tpu_torch.models.ranker import RankerModel, train_ranker
from otto_tpu_torch.models.recency import aid_weight_predictions
from otto_tpu_torch.models.sequence import (
    SequenceModel,
    sequence_params_from_numpy,
    sequence_params_to_numpy,
    sequence_serving_predictions,
    train_sequence_model,
)
from otto_tpu_torch.models.tfidf import TfIdfModel
