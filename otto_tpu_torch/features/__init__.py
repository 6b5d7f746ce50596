"""Feature families of the ranker (copied from ``otto_tpu/features``, numpy)."""

from otto_tpu_torch.features.aid_features import compute_aid_features
from otto_tpu_torch.features.session_features import compute_session_features
from otto_tpu_torch.features.interaction_features import assemble_features, compute_interaction_features

# The reference ranker's 52-feature list (models/lightgbm/config.yaml:5-26),
# identical across the click/cart/order sections.
RANKER_FEATURES = [
    "candidate_scores",
    "session_candidate_occurrence_count",
    "session_candidate_click_occurrence_count",
    "session_candidate_cart_occurrence_count",
    "session_candidate_order_occurrence_count",
    "aid_candidate_score_mean",
    "aid_candidate_score_std",
    "aid_candidate_score_max",
    "aid_session_candidate_occurrence_count_mean",
    "aid_session_candidate_occurrence_count_sum",
    "aid_session_candidate_occurrence_count_max",
    "aid_type_mean",
    "aid_hour_mean",
    "aid_hour_std",
    "aid_day_of_week_mean",
    "aid_day_of_week_std",
    "aid_ts_ratio",
    "aid_is_session_start_mean",
    "aid_is_session_end_mean",
    "aid_count_rank_pct",
    "aid_day_of_year_nunique_rank_pct",
    "aid_click_count_rank_pct",
    "aid_cart_count_rank_pct",
    "aid_order_count_rank_pct",
    "aid_click_session_nunique_rank_pct",
    "aid_cart_session_nunique_rank_pct",
    "aid_order_session_nunique_rank_pct",
    "aid_click_day_of_year_nunique_rank_pct",
    "aid_cart_day_of_year_nunique_rank_pct",
    "aid_order_day_of_year_nunique_rank_pct",
    "aid_last_week_count_rank_pct",
    "aid_last_week_ts_ratio",
    "aid_last_week_day_of_week_mean",
    "aid_click_last_week_occurrence_ratio",
    "aid_cart_last_week_occurrence_ratio",
    "aid_order_last_week_occurrence_ratio",
    "aid_click_last_week_occurrence_pct_change",
    "aid_cart_last_week_occurrence_pct_change",
    "aid_order_last_week_occurrence_pct_change",
    "session_count",
    "session_aid_nunique",
    "session_aid_last",
    "session_type_last",
    "session_day_of_week_last",
    "session_aid_count_mean",
    "session_aid_count_min",
    "session_aid_count_max",
    "session_aid_count_last",
    "session_aid_type_mean_mean",
    "session_aid_hour_mean_mean",
    "session_aid_session_nunique_rank_pct_mean",
    "session_aid_session_nunique_rank_pct_last",
    "session_aid_last_week_session_nunique_mean",
    "session_aid_last_week_session_nunique_last",
]

# RANKER_FEATURES + engineered extras that help the neural tower
EXTENDED_RANKER_FEATURES = RANKER_FEATURES + ["candidate_rank"]

__all__ = [
    "EXTENDED_RANKER_FEATURES",
    "compute_aid_features",
    "compute_session_features",
    "compute_interaction_features",
    "assemble_features",
    "RANKER_FEATURES",
]
