"""Drive the PyTorch port's paths once on one NVIDIA card: the
embedding-kNN path, the baselines with the covisitation heuristic, the
two-stage prediction path, the file CLI, GBDT training, SGNS training, the
listwise tower ranker, the TF-IDF recommender, the sequence recommenders,
matrix factorization and collaborative filtering with the training
utilities, sharded serving over a process mesh, data-parallel training
(the GBDT, the tower, the sequence models, ZeRO-1), model and expert
parallelism (tensor, sequence, pipeline, 3-D, expert-parallel MoE), the
oracle-parity tool and three of the examples.

    python3 chip_smoke.py

(``python3 chip_smoke.py --mesh-rank DIR`` is one rank of phases 16b, 17b
and 18b, which the script starts itself.)

Phases (each prints its seconds; any failure ends the run with a non-zero
exit code):

1. device and build: require CUDA, print the card's name and power limit,
   build the hand-written kernels from ``otto_tpu_torch/csrc`` and print
   each kernel's ptxas report (registers, spills);
2. each kernel against its plain-torch twin at the full-width shapes
   (1,855,603 items x 32 dims: stage 1 over 1,867,776 padded items at 256
   queries, at 115, the neighbor table's last batch, and at 4,096 x 102,
   the table's other batches, on the very inputs it is timed on; stage 1's
   deep wgmma route for bf16 deeper than 256 at DA 300; the peel on those batches'
   packed maxima and on tie-heavy and -inf rows, R = 1, 6, 21, 40), with
   the times of both at a 4,096-query batch (the peel's by CUDA graphs:
   device time alone), each kernel's share of its bound, ``torch.matmul``
   on the bare bf16 product as stage 1's yardstick and a windowed
   ``torch.topk`` as the peel's context (it differs on ties);
3. full-width retrieval: a seeded 1,855,603 x 32 SGNS table round-tripped
   through ``SGNSModel.save``/``load``, ``FusedRetriever`` queries/s and its
   recall against the exact scan;
3b. ``FusedRetriever`` on a seeded 1,000,000 x 96 table (compensated: a
   contraction of 294, past the wgmma kernel's 256, so stage 1 runs its
   deep wgmma route and never the FMA kernel), recall against the exact
   scan, with the counters zeroed before and read after; then that route
   against its twin on the retriever's own operands, its time beside the
   FMA kernel's and the twin's on them, and one launch at the full
   catalog's [4096 x 294] x [294 x 1,867,776]; then the same table as a
   float32 single-precision retriever (DA 98: the FMA kernel), recall and
   counters again, and the FMA kernel against its twin on its operands;
3c. the other retrieval backends on phase 3's table (every width full:
   1,855,603 x 32, k 21, 4,096-query batches): 3c-i the int8 stage-1 kernel
   on one batch against the int8 table, both metrics, bit-equal to its
   twin, its ms against its bound (set by the epilogue's instructions),
   the twin's and ``torch._int_mm``'s bare int8 product in slices; 3c-ii
   ``build_neighbor_table(backend="int8")``: its seconds, 454 launches of
   the int8 kernel and of the peel and none of K1's routes (counters zeroed
   before, read after), the prepared table's bytes beside the compensated
   retriever's, recall on 4,096 sampled aids against the exact top-21 of
   the quantized scores (>= 0.99) and against the float32 exact scan (no
   bar: the quantization's); 3c-iii ``topk_hybrid`` (euclidean) and
   ``topk_approx`` (dot), two batches each on the float32 table (the FMA
   kernel) and one on the table in bf16 (the wgmma kernel), recall against
   the exact scan (>= 0.99), the scores ``_rescore`` of the ids, then the
   FMA kernel against its twin on one batch of the float32 table's
   [4096 x 34] x [34 x 1,867,776] operands, with its times and bound (the
   FMA record's ``hybrid_path``); 3c-iv
   ``FusedRetriever.topk(rescore_survivors=True)`` on one batch of the
   compensated retriever, recall >= 0.99 and at least the plain
   ``topk``'s; the depth cut that pays for the phase is printed as a
   ``phase 3c cut:`` line (``tools/run_phase3c.py`` runs phases 3 and 3c
   alone);
4. the serving path in the order of ``otto_tpu.pipelines.run_embedding_knn``:
   ``neighbor_table(k=21)`` over every aid, ``embedding_knn_predictions`` on
   20,000 synthetic sessions, ``evaluate_predictions``; the kernels' launch
   counters are zeroed just before and read just after (its recency route
   launches the session vote);
5. the session vote against its twin at [4096, 256] and [1024, 300] (the
   block kernel for rows longer than 128; duplicates common, -1 tails):
   ``first``/``firstpos`` bit-equal, ``agg`` bit-equal on integer weights
   and within 2^-16 * sum_j |w_j| of its row on normal weights,
   ``per_aid_weight_top_fused`` against ``per_aid_weight_top`` and the CPU
   twin path; the kernel's times warm and cold (CUDA graphs; cold over
   rotating input copies of more than 50 MB) and the twin's;
6. ``build_covisitation`` on the card over the bench's data
   (``artifacts/bench_e2e/bench_fit.json``: ``synthetic_events_v2`` then
   ``split_by_time``) against the committed tables of
   ``artifacts/bench_e2e/covisitation``, which the JAX package wrote: six
   kinds bit-equal, ``time_weighted`` modulo near-ties;
7. ``pipelines.run_aid_frequency``, ``run_aid_weight`` and
   ``run_covisit_heuristic`` on 200,000 synthetic sessions over the
   1,855,603-aid catalog, ``CovisitConfig()`` defaults, with the counters
   zeroed before and read after; then the heuristic re-served on the host
   routes: the covisitation route must equal the device route;
8. the session vote at the shape phase 7's aid-weight runner gave it (the
   whole packed target, [20,000, L] with L the longest session; the warp
   kernel for rows up to 128): on the runner's own inputs against the
   twin, the runner's lists against the twin's ranking (equal up to
   near-ties), the checks of phase 5 on synthetic rows at [1,024, L], and
   the times of both at that shape, warm and cold;
9. the two-stage artifact replay, in the order of
   ``bench.py::e2e_artifact_bench``: phase 6's data, the committed
   covisitation tables and fold models of ``artifacts/bench_e2e``, aid
   features over train + target against the committed ``aid_feats.npz``,
   the first 8,000 training-disjoint sessions, the heuristic on the host
   routes, ``predict_two_stage`` on the card (counters zeroed before, read
   after: one float-row forest launch a type, no host binning; each
   stage's seconds), recall, lift and the paired bootstrap held to the CPU
   replay's numbers in ``BENCH_r05.json``; then the card's lists against
   the CPU twin path on 512 sessions (bit-equal); the pre-binned scoring
   path (``predict_binned_folds`` on numpy bins: the kernel's uint8 entry);
   the forest kernel's two entries against their twins on the path's own
   rows of each type and on rows of edge and special values (bit-equal;
   CUDA events and a CUDA graph), and the path once more with an SGNS model in
   the artifacts, so the kNN candidate route launches stage 1 and the
   peel: on the full catalog (phase 3's model, phase 7's tables and
   sessions), since a 20,000-aid table takes the dense route;
10. the file CLI, ``otto_tpu_torch.pipelines.main(argv)`` in this process
   with ``--device cuda`` (each step's seconds, the kernels' launches):
   10a phase 7's store written as a raw OTTO ``.jsonl`` (millisecond
   stamps) and as parquet, both read back (the native parser;
   ``EventStore.from_parquet``) equal to it, the parse's events/s;
   10b ``covisitation validation`` on the ``.jsonl``, its report equal to
   phase 7's field for field; 10c ``aid_weight submission`` on the
   parquet, the session vote launched, the file read back equal to
   ``run_aid_weight``'s lists, the writer's rows/s; 10d ``two_stage
   validation --ranker gbdt`` from a copy of ``artifacts/bench_e2e`` on
   phase 6's store cut to 20,000 sessions (10,000 target sessions): three
   float-row forest launches, recall, ``report_disjoint``, the stage
   seconds, sessions/s, and the saved lists equal to ``predict_two_stage``
   on the same train and target; 10e that command at 500 target
   sessions on the card and on the CPU, lists bit-equal (where they
   differ: every differing heuristic row a recency-route session, and the
   CPU path given the card's heuristic lists bit-equal to the card, the
   rows printed); 10f ``python -m otto_tpu_torch.pipelines aid_frequency
   submission --device cuda`` in a process of its own, exit 0 and a
   readable file;
11. GBDT training on the card (run in the order 11c, 11a, 11b, 11d: 11a and
   11b take the refit's rows): 11c the bench refit, ``run_two_stage_streamed``
   in training mode on phase 6's data with ``artifacts/BENCH_FIT_r05.json``'s
   settings (20,000 training sessions drawn with seed 23, bce, 150 trees, 3
   folds, early stop 50, ``min_data_in_leaf`` 200, selection seed 17) and
   the committed tables, streaming phase 9's 8,000 training-disjoint
   sessions; counters zeroed before and read after (the histogram kernel
   and the binning kernel launch, once a type; the histogram twin and numpy
   ``fit_bin_edges`` and ``bin_features`` are never called); the fits'
   seconds by function (upload, device edges, binning, tree growth, K5,
   OOF); best iterations and the lift with its paired bootstrap (1,000
   draws) held equal to the recorded refit to the printed digit, the ci95 above
   0 and overlapping the committed models'; the train-subsample report and
   the candidates' ceiling beside the JSON's; then each type's device edges
   held value-equal to numpy ``fit_bin_edges`` on the same rows; and the
   committed rankers resumed on the same training sessions, their fold
   average held to the JSON's train-subsample report and to the committed
   ``predictions.npz`` (that report is this in-sample one); 11a the
   histogram kernel against its twin at one tree's launches on the first
   clicks fold's rows (level 0, the root's row list; levels 1-6, the left
   children's stretches of the list as the tree's routing splits it):
   bit-equal on dyadic vals, bit-equal to the plain fixed-point reference
   on the fold's bce gradients and within 2^-20 of each column's sum of
   |vals| of the float64 twin, two launches bit-identical; its times (CUDA
   graph), the twin's, ``index_add_``'s, the list's split and the bound;
   then the binning kernel on the refit's clicks features against its
   twin and numpy (times of the kernel, the twin and ``torch.searchsorted``,
   and the bound); 11b one tree on dyadic grad/hess on the fold's first
   2,000 sessions, card against the CPU twin, bit-equal; two 10-tree bce fits on the card bit-identical; a
   5-tree lambdarank fit (``configs/gbdt_lambdarank.yaml``, trees cut) and
   ``_lambdarank_gh`` on its scores, card within 1e-5 relative of the CPU;
   11d the CLI's ``two_stage validation --config <20 trees, 3 folds>`` on
   phase 6's store cut to 10,000 sessions into an empty directory (three
   rankers saved, the histogram and binning kernels launched), the same
   command resuming (neither launched; lists equal to ``predict_two_stage``
   with the saved artifacts), and ``two_stage_streamed validation
   --train-sessions 2500`` on the same sessions (a lift printed);
12. SGNS training on the card with the published configs
   (``configs/fasttext.yaml``, ``configs/word2vec.yaml``), one epoch each,
   each cut printed: 12a the four SGNS steps (per-pair, weighted,
   shared-negative, hierarchical softmax) at full width on identical
   inputs on the card and the CPU (one batch of phase 7's fasttext pairs,
   negatives drawn on the host), within 1e-4 * (|x| + 0.01), and each
   step's ms against its bound; 12b ``train_sgns`` (fasttext ns, word2vec
   hs) and ``train_sgns_device`` (1,024 shared negatives) on phase 7's
   store cut to its first 100,000 sessions: pairs, pairs/s, ms a step, the loss falling, the device
   sampler's kept pairs against the host epoch's count; 12c one fasttext
   epoch on a planted-cluster corpus spread over the full catalog, then
   ``neighbor_table(k=21)`` (stage 1 and the peel launch) and
   ``embedding_knn_predictions`` (the session vote launches): the share of
   trained aids whose top neighbor shares their cluster, recall against
   the exact scan; 12d the CLI's ``embedding_knn validation``, ``doc2vec
   validation`` and ``embedding_knn submission`` on phase 7's store as
   parquet, the file equal to the runner's lists; 12e ``run_two_stage``
   with ``sgns_config`` on phase 11d's store cut to 10,000 sessions over a
   100,000-aid catalog: trains SGNS and the rankers and saves, then
   resumes with no training and lists equal to ``predict_two_stage``;
13. the listwise tower at ``configs/ranker.yaml``'s widths ((256, 256, 128),
   55 features), each cut printed: 13a the forward at [4,096 x 184 x 55]
   (its first 512 sessions against the CPU: 99% of scores within 1e-5 *
   (|s| + 1e-3), every one within 4e-3 * max |s|), one lambdarank step at
   [512 x 184 x 55] card against CPU (loss within 1e-5 relative in float32
   compute, 1e-4 in bfloat16), ms a step, and candidates scored per second
   at the reference bench's [1,024 x 128 x 52] against the float32 bound;
   13b ``run_two_stage(ranker_config=<configs/ranker.yaml>)`` on phase
   11d's store cut to 10,000 sessions into an empty directory (``train_s``,
   steps, each fold's loss falling from its first epoch to its last,
   MAP@20 per fold, ``report``, ``report_disjoint``, the paired bootstrap
   of the lift over the heuristic on the disjoint half with its ci95 upper
   end above 0), the same call resumed (no step; lists equal to
   ``predict_two_stage``), and on the store's first 5,000 sessions the
   tower paired with a small GBDT (K5, K4 and K4 bin launch) and
   ``run_two_stage_streamed`` training a tower; 13c the
   CLI's ``two_stage validation`` with no ``--ranker`` (the tower) into an
   empty directory, then resumed: reports, lists and files equal 13b's
   in-memory runs; 13d ``tfidf validation`` on phase 7's store as
   ``.jsonl`` (seconds, recall) and, on 2,000 target sessions, the card
   against the CPU (lists equal but for near-ties of the float32 scan,
   counted);
14. the sequence recommenders with the seven published configs
   (``configs/sequence_*.yaml``: dim 64, hidden 128, max_len 20, batch
   2,048, 512 negatives) over the full catalog, epochs cut to 1 (and the
   six non-default configs' training sessions to 10,000): 14a each
   config's session vectors on 512 of phase 7's sessions and one training
   step, card against CPU (vectors within 1e-5 * (|x| + 1e-3), the loss
   within 1e-5 relative, the updated parameters within 1e-4 * (|x| + 0.01)
   but where a rounding-level gradient decides Adam's sign, counted), ms a
   step against the dense Adam's bound; 14b ``pipelines.run_sequence`` with
   each config on the split of phase 7's store cut to its first 50,000
   sessions (``train_s``, steps, ms a step and the
   host draw's share, the loss falling from the first tenth of the steps to
   the last, routes, serve seconds, sessions/s, weighted recall@20, K1, K2
   and K3 launched); 14c K1 on the path's own operands ([4,096 x 198]
   against the compensated dim-64 table) and K3's block kernel on the
   recency route's [S, 256] input against their twins, with times and
   bounds, and ``full_sort_topk`` against the exact scan on 2,000 sessions
   (recall >= 0.99); 14d ``sequence validation`` through the CLI on 14b's
   50,000 sessions as ``.jsonl`` (report and lists equal to 14b's gru run: the
   card's training is bit-reproducible), ``sequence submission`` in a
   process of its own on 10,000 sessions, and a saved model loaded back
   (lists equal);
15. matrix factorization and collaborative filtering with the published
   configs (``configs/matrix_factorization.yaml``,
   ``configs/collaborative_filtering.yaml``: 32 factors, batch 262,144),
   each cut printed; no hand kernel launches (the counters are zeroed
   before and read after): 15a one sparse adagrad step of each at full
   table height (MF's 14,571,582 x 32 session and 1,855,604 x 32 aid
   tables, CF's 1,855,603 x 32 table with both lookups into it), card
   against CPU on the touched rows (within 1e-4 * (|x| + 0.01), the loss
   within 1e-5 relative), ms a step against the bytes the code moves;
   15b ``train_mf`` and ``train_cf`` on phase 7's split (epochs cut to 10:
   pair seconds, ``train_s``, ms a step, samples/s, the training loss
   falling, the validation scores), the card against a CPU run cut to 2
   epochs, both models saved and loaded back equal; 15c ``train_mf`` for
   one epoch at the full table shape (14,571,582 sessions of 2 events:
   ``train_s``, samples/s, the card's peak memory, finite tables); 15d
   ``TrainingGuard`` rolling back card tensors after a planted NaN, a
   ``trace`` of 3 steps, ``roofline()`` of 15a's step;
16. sharded serving and the row-sharded tables (``otto_tpu_torch.parallel``)
   at full width, each call's seconds printed: 16a one NCCL rank in this
   process (mesh (1, 1) on cuda:0): ``build_covisitation(mesh=)`` on phase
   6's data against phase 6's tables (ids equal, weights within 1e-5
   relative); ``regular_candidates(mesh=)`` and
   ``covisit_heuristic_predictions(mesh=)`` on phase 7's target sessions
   and tables with phase 4's neighbor table, against the single-device
   calls on the card (candidates and lists bit-equal, scores within 1e-5
   relative); the bytes of the tables both serving calls place; a
   ``ShardedRetriever`` over phase 3's 1,855,603 x 32 table, built once,
   its ``topk`` at 4,096 queries, k 21 (K1 and K2 launched, counters
   zeroed before and read after; ids equal to ``FusedRetriever.topk``'s,
   and those kept from a rank's block a prefix of ``FusedRetriever.topk``'s
   on the block alone; recall against the exact scan >= 0.99); ``sharded_lookup`` equal to indexing; the sharded MF step
   at 15a's heights and batch and the dense SGNS step at 1,855,603 x 32, B
   8,192, 40 negatives (touched rows within 1e-4 * (|x| + 0.01) of
   ``sparse_step`` and ``sgns_step`` on a batch of distinct rows), their ms;
   ``RankerModel.predict(mesh=)`` at 13a's [4,096 x 184 x 55] (bit-equality
   reported, 13a's limits held); 16b the same calls on the same inputs
   (files under ``tmp/chip_smoke_mesh``, removed at the end) in two gloo
   ranks sharing cuda:0 at meshes (1, 2) and (2, 1), after the dryrun's
   tiny shapes: K1 and K2 launched by each rank on its 927,802-row shard,
   each rank's MF shards, serving tables and kNN retriever about half of
   16a's bytes at (1, 2) and the whole at (2, 1), results under 16a's bars
   (``sharded_topk``'s ids equal at (2, 1), recall at both); then two NCCL
   ranks on the one card (``python -m otto_tpu_torch.parallel.dryrun``)
   must be refused, and NCCL's message is printed;
17. data-parallel training (``otto_tpu_torch.parallel.data_parallel``,
   ``fit_gbdt(mesh=)``) at full width: 17a in 16a's NCCL rank (mesh (1, 1)):
   ``fit_gbdt(mesh=)`` on 11a's first clicks fold ([1,857,664 x 55], 256
   bins, the refit's config, 30 trees) bit-equal to ``fit_gbdt`` (7 K5
   launches a tree on both routes, both timed), ``make_dp_ranker_step`` at
   13a's [4,096 x 184 x 55] bit-equal to ``train_step``,
   ``make_dp_sequence_step`` with ``configs/sequence_gru.yaml`` over the full
   catalog bit-equal to ``train_step``, the ZeRO-1 step bit-equal to the dp
   step over 3 Adam steps; 17b in 16b's two gloo ranks (mesh (2, 1)): the
   fold's 20-tree fit bit-equal to 17a's single-device one (7 K5 launches a
   tree a rank, the bytes each level all-reduces printed), the tower and
   sequence steps within 13a's and 14a's bars of the single-device steps,
   ZeRO-1 within 1e-5 of the dp step with about half its Adam state a rank;
18. model and expert parallelism (``otto_tpu_torch.parallel.model_parallel``,
   ``expert_parallel``) over the full catalog: the tensor-, tensor+sequence-
   and pipeline-parallel (2 microbatches) steps and the 3-D step at
   ``configs/sequence_transformer.yaml``'s widths, the tensor-parallel step
   with expert-parallel MoE FFNs at ``configs/sequence_moe.yaml``'s, and the
   expert-parallel pooled recommender (the same table, 4 experts), one step
   each after a warm-up step, each against the single-device step on the
   same card and inputs within 14a's bars: 18a in 16a's NCCL rank (meshes
   (1, 1) and (1, 1, 1), bit-equality printed), 18b in 16b's two gloo ranks
   (mesh (1, 2), the 3-D step at (1, 2, 1) and (1, 1, 2)); each step's ms,
   the bytes it handed to collectives and the Adam state a rank holds; no
   hand kernel launched (``tools/run_phase18.py`` runs the phase alone);
19. the oracle parity and the examples (``tools/run_phase19.py`` runs the
   phase alone): 19a ``tools/parity_run_torch.py``'s functions at 100,000
   sessions over its 100,000 aids (a depth cut from 1,000,000, printed as a
   ``phase 19 cut:`` line): the heuristic's covisitation route and the
   uncapped candidates exactly the oracle's lists (1.0 each type), the
   float64 host recency route at least 0.999, the device recency route
   printed; 19b ``examples/torch`` 03, 06 and 07 through their ``main`` at
   small sizes: 03's path launches K1-K3, K4, K4 bin and K5 (over 70,000
   aids, so that the kNN tables take stage 1's fused route), 06's K1 and K2
   and its serving process's lists equal this process's, 07's K5 and K4
   bin; each path joins ``launches_by_path``.

The line before the last is a JSON object describing each kernel (its
launches on the path it serves and on each path, largest error against the
twin, ms, the twin's ms, the bound and what sets it, and ``library_ms``,
null where no one PyTorch call computes the function); the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or without
the rest of the repository beside it, the script exits non-zero and prints
no result.  The phase functions take the device and the sizes, so a
rehearsal can import them and run them on the CPU at a small size (the
wrappers then run the plain twins).
"""

from __future__ import annotations

import contextlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 20260101
N_AIDS = 1_855_603        # real OTTO items (SURVEY §0)
DIM = 32                  # configs/fasttext.yaml, SGNSConfig.dim
K_NNS = 21                # run_embedding_knn's validation n_nns
QUERY_BATCH = 4096        # build_neighbor_table's query batch

REPO = Path(__file__).resolve().parent
K1_SOURCE = "otto_tpu_torch/csrc/retrieval_kernels.cu"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


@contextlib.contextmanager
def phase(name: str):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn`` on the card, by CUDA events around a
    loop of calls (the host's launch cost shows where a call is short)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fns, reps: int = 5) -> float:
    """Mean device milliseconds of one call of ``fns`` (a list of calls,
    each on its own inputs), captured once in a CUDA graph and replayed
    ``reps`` times: the kernel's time without the host's launch cost."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(max(1, 20 // len(fns))):
            for fn in fns:
                fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * max(1, 20 // len(fns)) * len(fns))


def warm_cold_ms(torch, call, inputs, min_bytes: float = 64e6) -> tuple[float, float]:
    """Device ms of ``call(*inputs)`` on the same inputs every time (warm:
    they stay in the 50 MB L2), and over rotating copies of the inputs
    that together exceed ``min_bytes`` (cold)."""
    per = sum(t.numel() * t.element_size() for t in inputs)
    copies = [inputs] + [tuple(t.clone() for t in inputs)
                         for _ in range(int(min_bytes // per))]
    warm = graph_ms(torch, [lambda: call(*inputs)])
    cold = graph_ms(torch, [lambda c=c: call(*c) for c in copies])
    return warm, cold


# Published H100 SXM peaks at 700 W (NVIDIA's data sheet, dense): device
# memory, bf16 tensor cores, float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12
# int32 operations outside the tensor cores: 132 SMs x 64 int32 lanes x
# 1.98 GHz (Hopper white paper)
INT32_OPS_PER_S = 16.7e12


def bound(n_bytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """The least time the card could take for a kernel's work, in ms, and
    what sets it: each input read once and each output written once over
    the memory rate, or the operations over their peak rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stage1_bound(q, t) -> tuple[float, str]:
    """Stage 1's bound: q [B, DA] and t [DA, N_pad] read once, [B, N_pad/128]
    float32 written once, 2 B DA N_pad operations at the bf16 tensor rate
    for bf16 operands and at the float32 rate for float32 ones (the tensor
    cores take float32 only as TF32, outside the float32 contract)."""
    n_pad = t.shape[1]
    rate = F32_OPS_PER_S if q.element_size() == 4 else BF16_TENSOR_OPS_PER_S
    return bound(q.numel() * q.element_size() + t.numel() * t.element_size()
                 + q.shape[0] * (n_pad // 128) * 4, 2.0 * q.numel() * n_pad, rate)


def matmul_yardstick_ms(torch, q, t, reps: int) -> tuple[float, int]:
    """CUDA-event ms of ``torch.matmul`` computing the bf16 product q @ t
    alone (no pack, no window max), in equal column slices of whole chunks
    into one reused output; returns (ms summed over the slices, slices).
    Timed as a yardstick only: the port never calls it."""
    from otto_tpu_torch.ops.fused_retrieval import CHUNK

    n_pad = t.shape[1]
    n_chunks = n_pad // CHUNK
    per = max(d for d in range(1, 17) if n_chunks % d == 0) * CHUNK
    buf = torch.empty((q.shape[0], per), dtype=torch.bfloat16, device=q.device)

    def run():
        for c0 in range(0, n_pad, per):
            torch.matmul(q, t[:, c0:c0 + per], out=buf)

    return cuda_ms(torch, run, reps), n_pad // per


def compare_kernels(torch, dev, n_items: int, b_cmp: int, peel_rows_cmp: int,
                    b_time: int, b_last: int) -> list[dict]:
    """Phase 2: each kernel against its twin at the shapes a table of
    ``n_items`` gives them; returns the kernels' records.

    Stage 1 runs at ``b_cmp`` queries and at ``b_last``, the neighbor
    table's last batch.  On integer-valued inputs it is exact, so bit-equal.
    On normal data the tensor cores and cuBLAS sum in other orders: a packed
    maximum may move by one truncation step (2^7 ulps) and change its 7-bit
    position code, so the bound is 2^8 ulps = 2^-15 relative.  Its deep
    wgmma route (bf16 deeper than 256) is held to the same limits at DA 300.  The
    peel is pure selection, bit-equal on the path's own packed maxima and on
    tie-heavy and -inf rows of ``peel_rows_cmp`` rows.
    """
    from otto_tpu_torch.ops import fused_retrieval as fr
    from otto_tpu_torch.ops import row_topk as rt

    n_pad = -(-n_items // fr.CHUNK) * fr.CHUNK
    g = torch.Generator(device=dev).manual_seed(SEED)
    k1_err = 0.0
    for b, da in ((b, da) for b in (b_cmp, b_last) for da in (34, 102)):
        q = torch.randint(-8, 9, (b, da), generator=g, device=dev).to(torch.bfloat16)
        t = torch.randint(-8, 9, (da, n_pad), generator=g, device=dev).to(torch.bfloat16)
        t[:, n_items:] = 0  # pad columns
        k = fr.fused_stage1(q, t)
        r = fr._stage1_reference(q, t)
        sync(torch, dev)
        check(torch.equal(k.view(torch.int32), r.view(torch.int32)),
              f"stage 1 DA={da} B={b}: kernel and twin differ on integer-valued inputs")
        # normal data, with a positivity shift in the last dimension as the
        # retriever folds one in
        qn = torch.randn((b, da), generator=g, device=dev)
        qn[:, -1] = 128.0
        tn = torch.randn((da, n_pad), generator=g, device=dev)
        tn[-1] = 1.0
        qn, tn = qn.to(torch.bfloat16), tn.to(torch.bfloat16)
        k = fr.fused_stage1(qn, tn)
        r = fr._stage1_reference(qn, tn)
        rel = ((k - r).abs() / r.abs()).max().item()
        same = ((k.view(torch.int32) & 127) == (r.view(torch.int32) & 127)).float().mean().item()
        k1_err = max(k1_err, (k - r).abs().max().item())
        # the float32 instantiation (FMA on the CUDA cores) on the same values
        kf = fr.fused_stage1(qn.float(), tn.float())
        rel_fma = ((kf - r).abs() / r.abs()).max().item()
        del kf
        print(f"stage 1 DA={da} B={b} N_pad={n_pad}: integer inputs bit-equal; "
              f"normal inputs max rel err {rel:.3e} (limit 2^-15; the float32 FMA kernel "
              f"on the same values {rel_fma:.3e}), same window position "
              f"{same:.6f} (limit 0.999)", flush=True)
        check(rel <= 2.0**-15, f"stage 1 DA={da} B={b}: relative error {rel}")
        check(same >= 0.999, f"stage 1 DA={da} B={b}: window positions agree on {same}")

    # the whole fused top-k on a small integer-valued table: the card's path
    # (kernels) equals the CPU's (twins), indices and scores
    gc = torch.Generator().manual_seed(SEED)
    items = torch.randint(-8, 9, (5 * fr.CHUNK + 123, DIM), generator=gc).float()
    queries = torch.randint(-8, 9, (64, DIM), generator=gc).float()
    for precision in ("single", "compensated"):
        (ks, ki), (rs, ri) = (
            fr.FusedRetriever(items, metric="euclidean", precision=precision,
                              device=d).topk(queries, k=K_NNS) for d in (dev, "cpu"))
        check(torch.equal(ki.cpu(), ri) and torch.equal(ks.cpu(), rs),
              f"FusedRetriever({precision}): card and CPU paths differ")
    print(f"FusedRetriever on {items.shape[0]} integer-valued items: card path equals "
          "the CPU twins' path (single, compensated)", flush=True)

    # the main path's shape, a 4096-query batch against the compensated
    # table: integer inputs bit-equal, then the timed normal inputs (with the
    # positivity shift, pad columns zero) within the limits
    qi = torch.randint(-8, 9, (b_time, 102), generator=g, device=dev).to(torch.bfloat16)
    ti = torch.randint(-8, 9, (102, n_pad), generator=g, device=dev).to(torch.bfloat16)
    ti[:, n_items:] = 0
    k, r = fr.fused_stage1(qi, ti), fr._stage1_reference(qi, ti)
    sync(torch, dev)
    check(torch.equal(k.view(torch.int32), r.view(torch.int32)),
          f"stage 1 DA=102 B={b_time}: kernel and twin differ on integer-valued inputs")
    del qi, ti
    qt = torch.randn((b_time, 102), generator=g, device=dev)
    qt[:, -1] = 128.0
    tt = torch.randn((102, n_pad), generator=g, device=dev)
    tt[-1] = 1.0
    tt[:, n_items:] = 0
    qt, tt = qt.to(torch.bfloat16), tt.to(torch.bfloat16)
    packed, r = fr.fused_stage1(qt, tt), fr._stage1_reference(qt, tt)
    live = r >= 1.0  # pad windows pack below 1.0 in both
    check(torch.equal(live, packed >= 1.0), f"stage 1 DA=102 B={b_time}: live windows differ")
    rel = ((packed - r).abs() / r.abs())[live].max().item()
    same = ((packed.view(torch.int32) & 127) == (r.view(torch.int32) & 127)).float().mean().item()
    k1_err = max(k1_err, (packed - r).abs().max().item())
    del r
    print(f"stage 1 DA=102 B={b_time} N_pad={n_pad} (the path's shape): integer inputs "
          f"bit-equal; normal inputs max rel err {rel:.3e} (limit 2^-15), same window "
          f"position {same:.6f} (limit 0.999)", flush=True)
    check(rel <= 2.0**-15, f"stage 1 DA=102 B={b_time}: relative error {rel}")
    check(same >= 0.999, f"stage 1 DA=102 B={b_time}: window positions agree on {same}")

    # stage 1's deep wgmma route: bf16 deeper than the wgmma kernel's 256, at
    # DA 300 over 2 chunks (a compensated table of 98 dims)
    deep_n = 2 * fr.CHUNK
    qi = torch.randint(-8, 9, (b_last, 300), generator=g, device=dev).to(torch.bfloat16)
    qi[:, -1] = 64
    ti = torch.randint(-8, 9, (300, deep_n), generator=g, device=dev).to(torch.bfloat16)
    before = fr.fused_stage1.deep_launches
    k, r = fr.fused_stage1(qi, ti), fr._stage1_reference(qi, ti)
    sync(torch, dev)
    check(dev.type != "cuda" or fr.fused_stage1.deep_launches == before + 1,
          "stage 1 DA=300 did not take the deep route")
    check(torch.equal(k.view(torch.int32), r.view(torch.int32)),
          "stage 1 deep route DA=300: kernel and twin differ on integer-valued inputs")
    qf = torch.randn((b_time, 300), generator=g, device=dev)
    qf[:, -1] = 128.0
    tf = torch.randn((300, deep_n), generator=g, device=dev)
    tf[-1] = 1.0
    qf, tf = qf.to(torch.bfloat16), tf.to(torch.bfloat16)
    k, r = fr.fused_stage1(qf, tf), fr._stage1_reference(qf, tf)
    rel_deep = ((k - r).abs() / r.abs()).max().item()
    same = ((k.view(torch.int32) & 127) == (r.view(torch.int32) & 127)).float().mean().item()
    check(rel_deep <= 2.0**-15, f"stage 1 deep route DA=300: relative error {rel_deep}")
    check(same >= 0.999, f"stage 1 deep route DA=300: window positions agree on {same}")
    print(f"stage 1 deep route, bf16 DA=300 over {deep_n} columns: integer inputs bit-equal "
          f"(B={b_last}); normal inputs (B={b_time}) max rel err {rel_deep:.3e} (limit 2^-15), "
          f"same window position {same:.6f} (limit 0.999)", flush=True)

    # the peel on the path's own packed maxima (this batch and the table's
    # last), and on tie-heavy (few distinct values) and -inf rows, for the
    # path's R = 6 and for R = 1, 21, 40
    m = n_pad // 128
    ties = torch.randint(0, 6, (peel_rows_cmp, m), generator=g, device=dev).float()
    ties[:, 128:256] = 3.0
    neginf = torch.randn((peel_rows_cmp, m), generator=g, device=dev)
    neginf[torch.rand((peel_rows_cmp, m), generator=g, device=dev) < 0.3] = float("-inf")
    neginf[:, 256:384] = float("-inf")
    k2_err = 0.0
    for name, x in (("K1's packed maxima", packed),
                    ("K1's packed maxima, last batch", fr.fused_stage1(qt[:b_last], tt)),
                    ("tie-heavy rows", ties), ("-inf rows", neginf)):
        for rounds in (1, 6, 21, 40):
            kv, kc = rt.peel_rows(x, rounds)
            rv, rc = rt.peel_rows_reference(x, rounds)
            check(torch.equal(kv.view(torch.int32), rv.view(torch.int32)) and torch.equal(kc, rc),
                  f"peel {name} R={rounds}: kernel and twin differ")
            k2_err = max(k2_err, torch.where(kv == rv, 0.0, (kv - rv).abs()).max().item())
        print(f"peel {name} {list(x.shape)} R=1, 6, 21, 40: kernel and twin bit-equal",
              flush=True)
    del ties, neginf

    # times at the path's shapes, on those inputs: loops of calls for the
    # long kernels, CUDA graphs (device time alone) for the peel
    reps = 3
    if dev.type == "cuda":
        loop_ms = lambda fn, n: cuda_ms(torch, fn, n)  # noqa: E731
        dev_ms = lambda fn: graph_ms(torch, [fn])  # noqa: E731
    else:  # a rehearsal on the CPU
        loop_ms, dev_ms = _host_ms, lambda fn: _host_ms(fn, 1)  # noqa: E731
    k1_ms = loop_ms(lambda: fr.fused_stage1(qt, tt), 10 * reps)
    k1_plain = loop_ms(lambda: fr._stage1_reference(qt, tt), reps)
    k1_ms2 = loop_ms(lambda: fr.fused_stage1(qt, tt), 10 * reps)
    deep_ms = loop_ms(lambda: fr.fused_stage1(qf, tf), 10 * reps)
    deep_plain = loop_ms(lambda: fr._stage1_reference(qf, tf), reps)
    k2_ms = dev_ms(lambda: rt.peel_rows(packed, 6))
    k2_plain = loop_ms(lambda: rt.peel_rows_reference(packed, 6), reps)
    k2_ms2 = dev_ms(lambda: rt.peel_rows(packed, 6))
    w = m // 128
    topk_ms = loop_ms(lambda: packed.view(b_time, w, 128).topk(6, dim=2), reps)
    k1_best, k2_best = min(k1_ms, k1_ms2), min(k2_ms, k2_ms2)
    mm_ms, slices = (matmul_yardstick_ms(torch, qt, tt, reps) if dev.type == "cuda"
                     else (None, 0))
    k1_bound = stage1_bound(qt, tt)
    deep_bound = stage1_bound(qf, tf)
    k2_bound = bound(packed.numel() * 4 + 2 * b_time * 6 * w * 4,
                     2.0 * 6 * packed.numel(), F32_OPS_PER_S)
    print(f"stage 1 [{b_time} x 102] x [102 x {n_pad}] bf16 (wgmma): kernel {k1_ms:.3f} / "
          f"{k1_ms2:.3f} ms, twin {k1_plain:.3f} ms; bound {k1_bound[0]:.3f} ms "
          f"({k1_bound[1]}): {100 * k1_bound[0] / k1_best:.1f}% of it", flush=True)
    if mm_ms is not None:
        print(f"torch.matmul yardstick, the bf16 product alone (no pack, no window max) in "
              f"{slices} column slices: {mm_ms:.3f} ms", flush=True)
    print(f"stage 1 deep route [{b_time} x 300] x [300 x {deep_n}] bf16: kernel "
          f"{deep_ms:.3f} ms, twin {deep_plain:.3f} ms; bound {deep_bound[0]:.4f} ms "
          f"({deep_bound[1]}): {100 * deep_bound[0] / deep_ms:.1f}% of it", flush=True)
    print(f"peel [{b_time}, {m}] R=6 on K1's packed maxima: kernel {k2_ms:.4f} / "
          f"{k2_ms2:.4f} ms (CUDA graph), twin {k2_plain:.3f} ms; bound {k2_bound[0]:.4f} ms "
          f"({k2_bound[1]}): {100 * k2_bound[0] / k2_best:.1f}% of it; context, not the same "
          f"function (it differs on ties): x.view(B, W, 128).topk(6, dim=2) {topk_ms:.3f} ms",
          flush=True)
    # library_ms: no one PyTorch call computes either function (K1 is a
    # product, a bit pack and a strided window max; torch.topk differs from
    # K2 on ties, since K2 clears every slot equal to the max)
    return [
        {"name": "fused_stage1", "route": "cuda", "source": K1_SOURCE,
         "replaces": "otto_tpu/ops/pallas_retrieval.py:68", "launches": 0,
         "max_abs_err": k1_err, "ms": k1_best, "plain_ms": k1_plain,
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1], "library_ms": None},
        {"name": "peel_rows", "route": "cuda", "source": K1_SOURCE,
         "replaces": "otto_tpu/ops/row_topk.py:38", "launches": 0,
         "max_abs_err": k2_err, "ms": k2_best, "plain_ms": k2_plain,
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1], "library_ms": None},
    ]


def _host_ms(fn, reps: int) -> float:
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def overlap(a: np.ndarray, b: np.ndarray) -> float:
    return sum(len(set(x.tolist()) & set(y.tolist())) for x, y in zip(a, b)) / a.size


def retrieval(torch, dev, n_aids: int, n_queries: int, n_recall: int, workdir: Path):
    """Phase 3: seeded table through save/load, fused top-k rate and recall.
    Returns the loaded model."""
    from otto_tpu_torch.models.embeddings import SGNSModel
    from otto_tpu_torch.ops.fused_retrieval import FusedRetriever
    from otto_tpu_torch.ops.retrieval import topk_scan

    rng = np.random.default_rng(SEED)
    w_in = rng.standard_normal((n_aids, DIM), dtype=np.float32)
    path = workdir / "sgns.npz"
    SGNSModel.from_jax_arrays(w_in, np.zeros_like(w_in), np.zeros(n_aids, np.float32),
                              device="cpu").save(path)
    model = SGNSModel.load(path, device=dev)
    check(model.w_in.shape == (n_aids, DIM) and model.device.type == dev.type,
          "loaded table shape/device")
    check(np.array_equal(model.w_in.cpu().numpy(), w_in), "save/load round trip")

    retriever = FusedRetriever(model.w_in, metric="euclidean", precision="compensated",
                               device=dev)
    q = model.w_in[torch.as_tensor(rng.choice(n_aids, n_queries, replace=False), device=dev)]
    retriever.topk(q, k=K_NNS)  # warm-up
    sync(torch, dev)
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        s, i = retriever.topk(q, k=K_NNS)
    sync(torch, dev)
    per_batch = (time.perf_counter() - t0) / reps
    check(bool(torch.isfinite(s).all()) and i.shape == (n_queries, K_NNS), "top-k output")
    _, ei = topk_scan(q[:n_recall], model.w_in, k=K_NNS, metric="euclidean")
    rec = overlap(i[:n_recall].cpu().numpy(), ei.cpu().numpy())
    print(f"FusedRetriever(euclidean, compensated) {n_aids} x {DIM}, {n_queries} queries "
          f"k={K_NNS}: {per_batch * 1e3:.1f} ms per batch, "
          f"{n_queries / per_batch:.0f} queries/s; recall vs exact scan on {n_recall} "
          f"queries {rec:.4f} (limit 0.99)", flush=True)
    check(rec >= 0.99, f"recall {rec} < 0.99")
    return model


def wide_retrieval(torch, dev, n_items: int, dim: int, n_queries: int,
                   table_dtype=None):
    """Phase 3b: ``FusedRetriever`` (euclidean) on a seeded ``n_items`` x
    ``dim`` table, compensated by default: with dim >= 84 the contraction
    3(dim + 2) passes the wgmma kernel's 256, so stage 1 takes its deep
    wgmma route.  With ``table_dtype=torch.float32`` the table is stored in
    single precision as float32 (DA dim + 2), which the FMA kernel takes.
    Recall against the exact scan.  The caller zeroes the launch counters
    before and reads them after.  Returns the retriever and the queries."""
    from otto_tpu_torch.ops.fused_retrieval import FusedRetriever
    from otto_tpu_torch.ops.retrieval import topk_scan

    rng = np.random.default_rng(SEED + 3)
    items = torch.as_tensor(rng.standard_normal((n_items, dim), dtype=np.float32), device=dev)
    q = items[torch.as_tensor(rng.choice(n_items, n_queries, replace=False), device=dev)]
    kind = ({"precision": "compensated"} if table_dtype is None else
            {"precision": "single", "table_dtype": table_dtype})
    label = ", ".join(str(v).removeprefix("torch.") for v in kind.values())
    t0 = time.perf_counter()
    retriever = FusedRetriever(items, metric="euclidean", device=dev, **kind)
    s, i = retriever.topk(q, k=K_NNS)
    sync(torch, dev)
    secs = time.perf_counter() - t0
    check(bool(torch.isfinite(s).all()) and i.shape == (n_queries, K_NNS), "wide top-k output")
    _, ei = topk_scan(q, items, k=K_NNS, metric="euclidean")
    rec = overlap(i.cpu().numpy(), ei.cpu().numpy())
    table = retriever.items_aug_t
    print(f"FusedRetriever(euclidean, {label}) {n_items} x {dim} (contraction "
          f"{table.shape[0]}), {n_queries} queries k={K_NNS}: {secs:.2f} s "
          f"with the table's preparation; recall vs exact scan {rec:.4f} (limit 0.99)",
          flush=True)
    check(rec >= 0.99, f"wide-table recall {rec} < 0.99")
    return retriever, q


def retriever_operands(torch, retriever, q):
    """The stage-1 operands ``FusedRetriever.topk`` hands ``fused_stage1``:
    the queries augmented (and split when compensated) and the table."""
    from otto_tpu_torch.ops import fused_retrieval as fr

    q_aug, _ = fr._augment_queries(q, retriever.max_sq, retriever.metric)
    if retriever.precision == "compensated":
        qhi, qlo = fr._bf16_split(q_aug)
        q_aug = torch.cat([qhi, qhi, qlo], dim=1)
    else:
        q_aug = q_aug.to(retriever.items_aug_t.dtype)
    return q_aug, retriever.items_aug_t


def stage1_close(torch, k, r, what: str) -> tuple[float, float, float]:
    """Phase 2's bars for stage 1 on normal data: the same live windows
    (pad windows pack below 1.0), values within 2^-15 relative on them,
    the same window position on >= 0.999 of cells.  Returns (max relative
    error, share of equal positions, max absolute error)."""
    live = r >= 1.0
    check(torch.equal(live, k >= 1.0), f"{what}: live windows differ")
    rel = ((k - r).abs() / r.abs())[live].max().item()
    same = ((k.view(torch.int32) & 127) == (r.view(torch.int32) & 127)).float().mean().item()
    check(rel <= 2.0**-15, f"{what}: relative error {rel}")
    check(same >= 0.999, f"{what}: window positions agree on {same}")
    return rel, same, (k - r).abs().max().item()


def wide_stage1_vs_twin(torch, dev, retriever, q, reps: int = 3) -> dict:
    """Phase 3b, after its counters are read: stage 1's deep wgmma route
    against its twin on the wide table's own operands (the retriever's
    augmented table, and the queries augmented and split as
    ``FusedRetriever.topk`` does), within phase 2's bars (the tensor cores
    and cuBLAS's float32 matmul sum in other orders); then the times of the
    route, of the FMA kernel on the same operands (its C entry called
    directly: the wrapper no longer sends it bf16 this shallow), of the
    twin and of ``torch.matmul``'s bare bf16 product.  The route must be at
    least 10x faster than the FMA kernel.  Returns its record for the
    kernels line."""
    from otto_tpu_torch.ops import _kernels
    from otto_tpu_torch.ops import fused_retrieval as fr

    q_aug, t = retriever_operands(torch, retriever, q)
    check(fr.stage1_route(q_aug.dtype, q_aug.shape[1]) == "wgmma_deep",
          f"the wide table's DA {q_aug.shape[1]} is not on the deep route")
    k, r = fr.fused_stage1(q_aug, t), fr._stage1_reference(q_aug, t)
    sync(torch, dev)
    rel, same, err = stage1_close(torch, k, r, "stage 1 deep route on the wide table")
    del k, r
    fma_ms = mm_ms = None
    if dev.type == "cuda":
        loop_ms = lambda fn, n: cuda_ms(torch, fn, n)  # noqa: E731
        out = torch.empty((q_aug.shape[0], t.shape[1] // fr.WINDOW), dtype=torch.float32,
                          device=dev)
        fma_ms = cuda_ms(torch, lambda: _kernels.launch_fused_stage1_fma(q_aug, t, out), reps)
        mm_ms, slices = matmul_yardstick_ms(torch, q_aug, t, reps)
        del out
    else:  # a rehearsal on the CPU
        loop_ms = _host_ms
    ms = loop_ms(lambda: fr.fused_stage1(q_aug, t), 10 * reps)
    plain_ms = loop_ms(lambda: fr._stage1_reference(q_aug, t), reps)
    ms2 = loop_ms(lambda: fr.fused_stage1(q_aug, t), 10 * reps)
    best = min(ms, ms2)
    b = stage1_bound(q_aug, t)
    shape = f"[{q_aug.shape[0]} x {t.shape[0]}] x [{t.shape[0]} x {t.shape[1]}] bf16"
    print(f"stage 1 deep route on the wide table's operands {shape}: max rel err {rel:.3e} "
          f"(limit 2^-15), same window position {same:.6f} (limit 0.999); kernel {ms:.4f} / "
          f"{ms2:.4f} ms, twin {plain_ms:.3f} ms; bound {b[0]:.4f} ms ({b[1]}): "
          f"{100 * b[0] / best:.1f}% of it", flush=True)
    if fma_ms is not None:
        print(f"the FMA kernel on the same operands {fma_ms:.3f} ms ({fma_ms / best:.1f}x the "
              f"deep route); torch.matmul's bare bf16 product (no pack, no window max) in "
              f"{slices} column slices {mm_ms:.3f} ms", flush=True)
        check(10 * best <= fma_ms, f"the deep route ({best} ms) is not 10x faster than the "
              f"FMA kernel ({fma_ms} ms)")
    return {"name": "fused_stage1_deep", "route": "cuda", "source": K1_SOURCE,
            "replaces": "otto_tpu/ops/pallas_retrieval.py:68", "launches": 0,
            "max_abs_err": err, "ms": best, "plain_ms": plain_ms,
            "bound_ms": b[0], "bound_by": b[1], "library_ms": None,
            "fma_kernel_ms": fma_ms, "matmul_bf16_product_ms": mm_ms}


def deep_full_catalog(torch, dev, b: int, da: int, n_items: int, reps: int = 3) -> dict:
    """Phase 3b: one deep-route launch at the full catalog's shape, [b x da]
    x [da x N_pad] bf16 over ``n_items`` items (pad columns zero): normal
    operands with the retriever's positivity shift, held to the twin within
    phase 2's bars, and its time against its bound."""
    from otto_tpu_torch.ops import fused_retrieval as fr

    n_pad = -(-n_items // fr.CHUNK) * fr.CHUNK
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    q = torch.randn((b, da), generator=g, device=dev)
    q[:, -1] = 128.0
    t = torch.randn((da, n_pad), generator=g, device=dev).to(torch.bfloat16)
    t[-1] = 1.0
    t[:, n_items:] = 0
    q = q.to(torch.bfloat16)
    before = fr.fused_stage1.deep_launches
    k = fr.fused_stage1(q, t)
    sync(torch, dev)
    check(dev.type != "cuda" or fr.fused_stage1.deep_launches == before + 1,
          f"stage 1 at [{b} x {da}] did not take the deep route")
    rel, same, _ = stage1_close(torch, k, fr._stage1_reference(q, t),
                                f"stage 1 deep route at [{b} x {da}] x [{da} x {n_pad}]")
    del k
    loop_ms = (lambda fn, n: cuda_ms(torch, fn, n)) if dev.type == "cuda" else _host_ms
    ms = [loop_ms(lambda: fr.fused_stage1(q, t), reps) for _ in range(2)]
    bd = stage1_bound(q, t)
    print(f"stage 1 deep route at the full catalog's [{b} x {da}] x [{da} x {n_pad}] bf16: max "
          f"rel err {rel:.3e}, same window position {same:.6f}; kernel {ms[0]:.4f} / "
          f"{ms[1]:.4f} ms; bound {bd[0]:.4f} ms ({bd[1]}): {100 * bd[0] / min(ms):.1f}% of it",
          flush=True)
    return {"shape": [b, da, n_pad], "ms": min(ms), "bound_ms": bd[0], "bound_by": bd[1],
            "max_rel_err": rel}


def f32_stage1_vs_twin(torch, dev, retriever, q, reps: int = 3,
                       table: str = "the float32 wide table") -> dict:
    """The FMA kernel against its twin on a float32 single-precision
    retriever's own operands (DA dim + 2; phase 3b's wide table, 3c-iii's
    ``topk_hybrid`` table), within phase 2's bars (it sums in ascending d,
    cuBLAS in another order), and the times of both; the bound prices its
    operations at the float32 rate.  Returns its record for the kernels
    line."""
    from otto_tpu_torch.ops import fused_retrieval as fr

    q_aug, t = retriever_operands(torch, retriever, q)
    check(fr.stage1_route(q_aug.dtype, q_aug.shape[1]) == "fma",
          f"{table} (DA {q_aug.shape[1]}) is not on the FMA route")
    k, r = fr.fused_stage1(q_aug, t), fr._stage1_reference(q_aug, t)
    sync(torch, dev)
    rel, same, err = stage1_close(torch, k, r, f"stage 1 FMA kernel on {table}")
    del k, r
    loop_ms = (lambda fn, n: cuda_ms(torch, fn, n)) if dev.type == "cuda" else _host_ms
    ms = loop_ms(lambda: fr.fused_stage1(q_aug, t), reps)
    plain_ms = loop_ms(lambda: fr._stage1_reference(q_aug, t), reps)
    ms2 = loop_ms(lambda: fr.fused_stage1(q_aug, t), reps)
    b = stage1_bound(q_aug, t)
    print(f"stage 1 FMA kernel on {table}'s operands [{q_aug.shape[0]} x "
          f"{t.shape[0]}] x [{t.shape[0]} x {t.shape[1]}] float32: max rel err {rel:.3e} (limit "
          f"2^-15), same window position {same:.6f} (limit 0.999); kernel {ms:.3f} / {ms2:.3f} "
          f"ms, twin {plain_ms:.3f} ms; bound {b[0]:.4f} ms ({b[1]}, at the float32 rate): "
          f"{100 * b[0] / min(ms, ms2):.1f}% of it", flush=True)
    return {"name": "fused_stage1_fma", "route": "cuda", "source": K1_SOURCE,
            "replaces": "otto_tpu/ops/pallas_retrieval.py:68", "launches": 0,
            "max_abs_err": err, "ms": min(ms, ms2), "plain_ms": plain_ms,
            "bound_ms": b[0], "bound_by": b[1], "library_ms": None,
            "shape": [q_aug.shape[0], t.shape[0], t.shape[1]]}


# The int8 stage-1 kernel's bound (its source's note): the int8 tensor
# cores' dense rate, and the epilogue's CUDA-core instructions a score as
# counted in the kernel's source (the int-to-float conversion, two FMULs,
# the shift's FADD, one LOP3, one FMNMX; euclidean adds the FFMA of 2 s - sq),
# at one warp instruction a clock a scheduler: 132 SMs x 128 lanes x
# 1.98 GHz.
INT8_SOURCE = "otto_tpu_torch/csrc/int8_retrieval_kernels.cu"
INT8_TENSOR_OPS_PER_S = 1979e12
CUDA_CORE_INSTR_PER_S = 132 * 128 * 1.98e9
INT8_EPILOGUE_INSTR = {"dot": 6, "euclidean": 7}
INT8_RECALL = 0.99  # phase 3c's bars against the exact scans
SCAN_BLOCK = 1 << 16  # phase 3c's exact scans (topk_scan) of 4,096 queries


def int8_stage1_bound(b: int, d_pad: int, n_pad: int, metric: str) -> tuple[float, str, dict]:
    """The int8 kernel's bound in ms and what sets it: the bytes (q8,
    q_scale, the table, its scales and, for euclidean, its norms read once;
    the packed maxima written once), the int8 tensor operations 2 B D_pad
    N_pad, and the epilogue's instructions; with each part's ms."""
    n_bytes = b * d_pad + 4 * b + n_pad * d_pad + 4 * n_pad * (2 if metric == "euclidean" else 1) \
        + 4 * b * (n_pad // 128)
    parts = {"bytes_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
             "tensor_ms": 2.0 * b * d_pad * n_pad / INT8_TENSOR_OPS_PER_S * 1e3,
             "epilogue_ms": b * n_pad * INT8_EPILOGUE_INSTR[metric] / CUDA_CORE_INSTR_PER_S * 1e3}
    top = max(parts, key=parts.get)
    return parts[top], "bytes" if top == "bytes_ms" else "operations", parts


def int_mm_product_ms(torch, q8, table8, reps: int) -> tuple[float | None, str]:
    """CUDA-event ms of ``torch._int_mm``'s bare int8 product q8 @ table8.T
    (no rescale, no pack, no window max) in equal slices of whole chunks into
    one reused int32 output, summed over the slices; context only, the port
    never calls it.  (None, the reason) if the call refuses the operands."""
    from otto_tpu_torch.ops.fused_retrieval import CHUNK

    n_pad = table8.shape[0]
    n_chunks = n_pad // CHUNK
    per = max(d for d in range(1, 17) if n_chunks % d == 0) * CHUNK
    buf = torch.empty((q8.shape[0], per), dtype=torch.int32, device=q8.device)

    def run():
        for c0 in range(0, n_pad, per):
            torch._int_mm(q8, table8[c0:c0 + per].t(), out=buf)

    try:
        run()
        return cuda_ms(torch, run, reps), f"{n_pad // per} slices"
    except RuntimeError as e:
        return None, f"refused: {str(e).splitlines()[0]}"


def without_self(ids, rows, k: int):
    """The first ``k`` ids [B, k + 1] of each row but its own id ``rows``
    [B] (a neighbor table's exact row from a scan of k + 1)."""
    keep = ids != rows[:, None]
    cols = np.argsort(~keep, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(ids, cols, axis=1)


def quantized_topk(torch, retriever, q, k: int):
    """Exact top-k ids [B, k] (numpy) of an ``Int8Retriever``'s quantized
    scores of queries ``q``: integer products in float32 (TF32 off), 2^18
    items at a time."""
    from otto_tpu_torch.ops.fused_retrieval import quantize_rows_int8
    from otto_tpu_torch.utils.runtime import full_f32_matmul

    q8q, qs = quantize_rows_int8(q.to(torch.float32))
    qf = q8q.to(torch.float32)
    best_s = best_i = None
    for c0 in range(0, retriever.n_items, 1 << 18):
        c1 = min(c0 + (1 << 18), retriever.n_items)
        with full_f32_matmul():
            acc = qf @ retriever.q8[c0:c1].to(torch.float32).T
        s = retriever._scores(acc, qs, retriever.scale[None, c0:c1], retriever.sq[None, c0:c1])
        v, i = torch.topk(s, min(k, c1 - c0), dim=1)
        i = i + c0
        if best_s is not None:
            v, pos = torch.topk(torch.cat([best_s, v], 1), k, dim=1)
            i = torch.gather(torch.cat([best_i, i], 1), 1, pos)
        best_s, best_i = v, i
    return best_i.cpu().numpy()


def int8_stage1_vs_twin(torch, dev, w_in, n_queries: int, reps: int = 10) -> dict:
    """Phase 3c-i: the int8 kernel on one batch of ``n_queries`` aids
    against the full table, for both metrics, bit-equal to its twin; its
    times, the twin's, ``torch._int_mm``'s bare product and the bound.
    Returns the kernels line's record (the euclidean metric's numbers, the
    neighbor table's; the dot metric's beside them)."""
    from otto_tpu_torch.ops import fused_retrieval as fr
    from otto_tpu_torch.ops.retrieval import quantize_items_int8

    rng = np.random.default_rng(SEED + 5)
    q = w_in[torch.as_tensor(rng.choice(w_in.shape[0], n_queries, replace=False), device=dev)]
    quant = quantize_items_int8(w_in)
    out = {}
    for metric in ("dot", "euclidean"):
        r8 = fr.Int8Retriever(*quant, metric=metric, device=dev)
        q8q, qs = fr.quantize_rows_int8(q)
        q8p = torch.nn.functional.pad(q8q, (0, r8.table8.shape[1] - r8.dim))
        args = (q8p, qs, r8.table8, r8.item_scale, r8.item_bias)
        kw = {"n_items": r8.n_items, "shift": r8._shift(q8q, qs), "metric": metric}
        k, r = fr.fused_stage1_int8(*args, **kw), fr._stage1_int8_reference(*args, **kw)
        sync(torch, dev)
        check(torch.equal(k.view(torch.int32), r.view(torch.int32)),
              f"3c-i: the int8 kernel differs from its twin ({metric})")
        live = (r.view(torch.int32) >= fr.LIVE_BITS).float().mean().item()
        del k, r
        loop_ms = (lambda fn, n: cuda_ms(torch, fn, n)) if dev.type == "cuda" else _host_ms
        ms = [loop_ms(lambda: fr.fused_stage1_int8(*args, **kw), reps) for _ in range(2)]
        plain_ms = loop_ms(lambda: fr._stage1_int8_reference(*args, **kw), 1)
        mm_ms, mm_how = (int_mm_product_ms(torch, q8p, r8.table8, 3) if dev.type == "cuda"
                         else (None, "not on the CPU"))
        b_ms, b_by, parts = int8_stage1_bound(n_queries, q8p.shape[1], r8.table8.shape[0],
                                              metric)
        shape = f"[{n_queries} x {q8p.shape[1]}] x [{q8p.shape[1]} x {r8.table8.shape[0]}] int8"
        print(f"3c-i int8 stage 1 ({metric}) {shape}: bit-equal to its twin (live windows "
              f"{live:.6f}); kernel {ms[0]:.4f} / {ms[1]:.4f} ms, twin {plain_ms:.3f} ms; "
              f"bound {b_ms:.4f} ms ({b_by}: {json.dumps(parts)}): "
              f"{100 * b_ms / min(ms):.1f}% of it; torch._int_mm's bare product "
              f"{'%.4f ms' % mm_ms if mm_ms is not None else 'not timed'} ({mm_how})",
              flush=True)
        out[metric] = {"ms": min(ms), "ms_runs": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                       "bound_by": b_by, "bound_parts": parts, "int_mm_product_ms": mm_ms}
        del r8, args
    e = out["euclidean"]
    return {"name": "fused_stage1_int8", "route": "cuda", "source": INT8_SOURCE,
            "replaces": "otto_tpu/ops/retrieval.py:295", "launches": 0, "max_abs_err": 0.0,
            "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
            "bound_by": e["bound_by"], "library_ms": None,
            "int_mm_product_ms": e["int_mm_product_ms"], "bound_parts": e["bound_parts"],
            "dot": out["dot"]}


def int8_neighbor_table(torch, dev, w_in, n_recall: int, zero_counters, read_counters) -> dict:
    """Phase 3c-ii: ``build_neighbor_table(backend="int8")`` over the full
    table (counters zeroed before, read after: the int8 kernel and the peel
    once a batch, none of K1's routes), its seconds, the prepared table's
    bytes beside the compensated retriever's, recall on ``n_recall``
    sampled aids against the exact top-k of the quantized scores (>= 0.99)
    and against the float32 exact scan (the quantization's, no bar)."""
    from otto_tpu_torch.ops import fused_retrieval as fr
    from otto_tpu_torch.ops.retrieval import build_neighbor_table, quantize_items_int8, topk_scan

    n = w_in.shape[0]
    zero_counters()
    t0 = time.perf_counter()
    table = build_neighbor_table(w_in, k=K_NNS, backend="int8", device=dev)
    secs = time.perf_counter() - t0
    launches = read_counters("int8 neighbor table", ("fused_stage1_int8", "peel_rows")
                             if dev.type == "cuda" else ())
    batches = -(-n // QUERY_BATCH)
    if dev.type == "cuda":
        check(launches["fused_stage1_int8"] == batches and launches["peel_rows"] == batches,
              f"3c-ii: {launches} for {batches} query batches")
        check(not any(launches[r] for r in ("fused_stage1", "fused_stage1_deep",
                                            "fused_stage1_fma")), f"3c-ii: K1 ran: {launches}")
    r8 = fr.Int8Retriever(*quantize_items_int8(w_in), metric="euclidean", device=dev)
    comp = fr.FusedRetriever(w_in, metric="euclidean", precision="compensated", device=dev)
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    comp_bytes = nbytes(comp.items_aug_t, comp.items, comp.sq)
    int8_bytes = nbytes(r8.table8, r8.item_scale, r8.item_bias)
    ids = torch.as_tensor(np.random.default_rng(SEED + 6).choice(n, n_recall, replace=False),
                          device=dev)
    rows = ids.cpu().numpy()
    got = table[rows]
    q = w_in[ids]
    want_q = without_self(quantized_topk(torch, r8, q, K_NNS + 1), rows, K_NNS)
    want_f = without_self(topk_scan(q, w_in, k=K_NNS + 1, block=SCAN_BLOCK,
                                    metric="euclidean")[1].cpu().numpy(), rows, K_NNS)
    rec_q, rec_f = overlap(got, want_q), overlap(got, want_f)
    print(f"3c-ii build_neighbor_table(backend='int8') {n} x {w_in.shape[1]}, k={K_NNS}: "
          f"{secs:.3f} s; launches {launches}; the prepared int8 table {int8_bytes} bytes "
          f"against the compensated retriever's {comp_bytes} ({int8_bytes / comp_bytes:.3f}x); "
          f"recall on {n_recall} aids vs the exact quantized top-{K_NNS} {rec_q:.4f} "
          f"(limit {INT8_RECALL}), vs the float32 exact scan {rec_f:.4f} (the quantization's, "
          f"no bar)", flush=True)
    check(rec_q >= INT8_RECALL, f"3c-ii: recall {rec_q} vs the quantized scan")
    return {"s": secs, "launches": launches, "int8_bytes": int8_bytes,
            "compensated_bytes": comp_bytes, "recall_quantized": rec_q, "recall_f32": rec_f,
            "retriever": comp}


def hybrid_approx(torch, dev, w_in, n_queries: int, zero_counters, read_counters) -> dict:
    """Phase 3c-iii: ``topk_hybrid`` (euclidean) and ``topk_approx`` (dot),
    each on two ``n_queries`` batches of the float32 table (stage 1's FMA
    kernel) and one of the table in bf16 (the wgmma kernel), counters
    zeroed before and read after each; recall against the exact scan of the
    same table (>= 0.99), and the returned scores ``_rescore`` of the
    returned ids (within 1e-6 relative: a [B, k] product may sum a column in
    another order once the columns are sorted; the share bit-equal is
    printed).  Then the FMA kernel against its twin on one batch of the
    float32 table's operands (``fma_vs_twin``, its record at this shape)."""
    from otto_tpu_torch.ops import fused_retrieval as fr
    from otto_tpu_torch.ops.retrieval import hybrid_retriever, topk_approx, topk_hybrid, topk_scan

    n = w_in.shape[0]
    rng = np.random.default_rng(SEED + 7)
    w_bf16 = w_in.to(torch.bfloat16)
    out = {}
    for fn, metric in ((topk_hybrid, "euclidean"), (topk_approx, "dot")):
        name = fn.__name__
        zero_counters()
        runs = []
        t0 = time.perf_counter()
        for items in (w_in, w_in, w_bf16):
            q = w_in[torch.as_tensor(rng.choice(n, n_queries, replace=False), device=dev)]
            s, i = fn(q, items, K_NNS, metric=metric)
            runs.append((items, q, s, i))
        sync(torch, dev)
        secs = time.perf_counter() - t0
        launches = read_counters(f"{name} path", ("fused_stage1_fma", "fused_stage1", "peel_rows")
                                 if dev.type == "cuda" else ())
        if dev.type == "cuda":
            check(launches["fused_stage1_fma"] == 2 and launches["fused_stage1"] == 1
                  and launches["peel_rows"] == 3, f"3c-iii {name}: {launches}")
        recs, same = [], []
        for items, q, s, i in runs:
            itf = items.to(torch.float32)
            _, want = topk_scan(q, itf, k=K_NNS, block=SCAN_BLOCK, metric=metric)
            recs.append(overlap(i.cpu().numpy(), want.cpu().numpy()))
            again = fr._rescore(itf, (itf * itf).sum(dim=1), q, i.long(), metric)
            check(torch.allclose(s, again, rtol=1e-6, atol=1e-5),
                  f"3c-iii {name}: scores are not _rescore of the ids")
            same.append((s == again).float().mean().item())
        print(f"3c-iii {name} ({metric}) {n} x {w_in.shape[1]}, 2 x {n_queries} queries on the "
              f"float32 table and {n_queries} on bf16, k={K_NNS}: {secs:.3f} s; launches "
              f"{launches}; recall vs the exact scan {[round(r, 4) for r in recs]} (limit "
              f"{INT8_RECALL}); scores _rescore of the ids, bit-equal on "
              f"{[round(x, 6) for x in same]}", flush=True)
        check(min(recs) >= INT8_RECALL, f"3c-iii {name}: recall {recs}")
        out[name] = {"s": secs, "launches": launches, "recall": recs}
    q = w_in[torch.as_tensor(rng.choice(n, n_queries, replace=False), device=dev)]
    out["fma_vs_twin"] = f32_stage1_vs_twin(
        torch, dev, hybrid_retriever(w_in, "euclidean", torch.float32, dev), q,
        table="topk_hybrid's float32 table")
    return out


def survivors_batch(torch, dev, retriever, n_queries: int, zero_counters,
                    read_counters) -> dict:
    """Phase 3c-iv: ``FusedRetriever.topk(rescore_survivors=True)`` on one
    batch of the compensated retriever over the full table: recall against
    the exact scan >= 0.99 and at least the plain ``topk``'s on the batch;
    the times of both."""
    from otto_tpu_torch.ops import fused_retrieval as fr
    from otto_tpu_torch.ops.retrieval import topk_scan

    n = retriever.n_items
    rng = np.random.default_rng(SEED + 8)
    q = retriever.items[torch.as_tensor(rng.choice(n, n_queries, replace=False), device=dev)]
    zero_counters()
    t0 = time.perf_counter()
    s, i = retriever.topk(q, k=K_NNS, rescore_survivors=True)
    sync(torch, dev)
    secs = time.perf_counter() - t0
    launches = read_counters("rescore_survivors path", ("fused_stage1", "peel_rows")
                             if dev.type == "cuda" else ())
    t0 = time.perf_counter()
    _, i0 = retriever.topk(q, k=K_NNS)
    sync(torch, dev)
    plain_s = time.perf_counter() - t0
    _, want = topk_scan(q, retriever.items, k=K_NNS, block=SCAN_BLOCK, metric="euclidean")
    rec, rec0 = (overlap(x.cpu().numpy(), want.cpu().numpy()) for x in (i, i0))
    # the survivors were rescored as a [B, rounds * windows] block, so a
    # score may differ in its summation order from a [B, k] rescoring
    check(torch.allclose(s, fr._rescore(retriever.items, retriever.sq, q, i.long(), "euclidean"),
                         rtol=1e-6, atol=1e-5), "3c-iv: scores are not _rescore of the ids")
    print(f"3c-iv FusedRetriever(compensated).topk(rescore_survivors=True) {n_queries} queries "
          f"k={K_NNS}: {secs * 1e3:.1f} ms (plain topk {plain_s * 1e3:.1f} ms); launches "
          f"{launches}; recall vs the exact scan {rec:.4f} (plain {rec0:.4f}; limit "
          f"{INT8_RECALL} and >= plain)", flush=True)
    check(rec >= INT8_RECALL and rec >= rec0, f"3c-iv: recall {rec}, plain {rec0}")
    return {"s": secs, "plain_s": plain_s, "launches": launches, "recall": rec,
            "plain_recall": rec0}


def serve(torch, dev, model, n_sessions: int, n_check: int):
    """Phase 4: the serving path of run_embedding_knn, then its checks."""
    from otto_tpu_torch.data.splits import split_by_fraction
    from otto_tpu_torch.data.synthetic import synthetic_events_v2
    from otto_tpu_torch.eval.harness import evaluate_predictions
    from otto_tpu_torch.models.embeddings import embedding_knn_predictions
    from otto_tpu_torch.ops.retrieval import topk_scan

    n_aids = model.w_in.shape[0]
    sp = split_by_fraction(synthetic_events_v2(n_sessions=n_sessions, n_aids=n_aids,
                                               seed=SEED))
    t0 = time.perf_counter()
    table = model.neighbor_table(k=K_NNS)
    table_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    preds = embedding_knn_predictions(sp.val_input, table, k=20, device=dev)
    sync(torch, dev)
    predict_s = time.perf_counter() - t0
    report = evaluate_predictions(sp.val_labels, preds["clicks"], preds["carts"],
                                  preds["orders"], device=dev)
    print(f"neighbor table k={K_NNS} over {n_aids} aids: {table_s:.2f} s; predict "
          f"{sp.val_input.n_sessions} sessions: {predict_s:.2f} s", flush=True)
    print(f"weighted recall@20 {report.weighted:.6f} (clicks {report.clicks:.6f}, carts "
          f"{report.carts:.6f}, orders {report.orders:.6f})", flush=True)

    check(table.shape == (n_aids, K_NNS) and table.min() >= 0 and table.max() < n_aids,
          "neighbor table range")
    check(not (table == np.arange(n_aids)[:, None]).any(), "self in neighbor rows")
    p = preds["clicks"]
    check(p.shape == (sp.val_input.n_sessions, 20) and p.min() >= -1 and p.max() < n_aids,
          "prediction shape/range")
    check(0.0 <= report.weighted <= 1.0 and np.isfinite(report.weighted), "weighted recall")
    # table rows against the exact scan (self excluded) on sampled aids
    sample = np.random.default_rng(SEED + 1).choice(n_aids, n_check, replace=False)
    _, ei = topk_scan(model.w_in[torch.as_tensor(sample, device=dev)], model.w_in,
                      k=K_NNS + 1, metric="euclidean")
    ei = ei.cpu().numpy()
    exact = np.stack([r[r != a][:K_NNS] for r, a in zip(ei, sample)])
    rec = overlap(table[sample], exact)
    print(f"neighbor rows vs exact scan on {n_check} aids: overlap {rec:.4f} "
          f"(limit 0.99)", flush=True)
    check(rec >= 0.99, f"neighbor-table overlap {rec} < 0.99")
    return table


def vote_bound(torch, w):
    """The bound on ``agg`` against the twin, per row: the twin sums by
    einsum, so on fractional weights the last bits may differ."""
    return 2.0**-16 * w.abs().sum(dim=1, keepdim=True)


def vote_time_bound(torch, aids) -> tuple[float, str]:
    """The session vote's bound on these rows: aids and weights read, agg,
    first and firstpos written, 4 bytes each a position; or its operations,
    a compare and an add for each pair of positions in a row's live prefix
    (up to its last aid >= 0; no later slot can match a real aid)."""
    S, L = aids.shape
    live = aids >= 0
    hi = torch.where(live.any(dim=1), L - live.flip(1).to(torch.int32).argmax(dim=1), 0)
    return bound(S * L * 4 * 5, 2.0 * float((hi.double() ** 2).sum()), F32_OPS_PER_S)


def compare_vote(torch, dev, S: int, L: int, n_cpu: int, reps: int = 20) -> dict:
    """The session vote against its twin on synthetic rows at [S, L]: the
    largest ``agg`` error and, when ``reps`` > 0, the times of both."""
    from otto_tpu_torch.ops import fused_sessions as fs
    from otto_tpu_torch.ops import sessions as ses

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    aids = torch.randint(0, 48, (S, L), generator=g, device=dev, dtype=torch.int32)
    tail = torch.randint(0, L + 1, (S, 1), generator=g, device=dev)
    aids[torch.arange(L, device=dev)[None, :] >= L - tail] = -1
    valid = aids >= 0
    w_int = torch.where(valid, torch.randint(1, 7, (S, L), generator=g, device=dev).float(), 0.0)
    w_norm = torch.where(valid, torch.randn((S, L), generator=g, device=dev), 0.0)
    err = 0.0
    for name, w in (("integer", w_int), ("normal", w_norm)):
        ka, kf, kp = fs.aid_vote_aggregate(aids, w)
        ra, rf, rp = fs._vote_reference(aids, w)
        sync(torch, dev)
        check(torch.equal(kf, rf) and torch.equal(kp, rp),
              f"vote ({name} weights): first/firstpos differ from the twin")
        d = (ka - ra).abs()
        check(bool((d <= vote_bound(torch, w)).all()),
              f"vote ({name} weights): agg beyond 2^-16 * sum|w|")
        if name == "integer":
            check(torch.equal(ka, ra), "vote (integer weights): agg differs from the twin")
        err = max(err, d.max().item())
        print(f"vote [{S}, {L}] {name} weights: first/firstpos bit-equal, agg max abs err "
              f"{d.max().item():.3e} (limit 2^-16 * sum|w| of the row)", flush=True)

    fa, fw = fs.per_aid_weight_top_fused(aids, w_int, valid, k=20)
    pa, pw = ses.per_aid_weight_top(aids, w_int, valid, k=20)
    ca, cw = ses.per_aid_weight_top(aids[:n_cpu].cpu(), w_int[:n_cpu].cpu(), valid[:n_cpu].cpu(),
                                    k=20)
    check(torch.equal(fa, pa) and torch.equal(torch.where(pa >= 0, pw, 0.0), fw),
          "per_aid_weight_top_fused and per_aid_weight_top differ")
    check(torch.equal(pa[:n_cpu].cpu(), ca) and torch.equal(pw[:n_cpu].cpu(), cw),
          "per_aid_weight_top on the card and on the CPU twin differ")
    print(f"top-20 on integer weights: fused == per_aid_weight_top on [{S}, {L}], == CPU twin "
          f"path on {n_cpu} rows", flush=True)

    if not reps:
        return {"err": err}
    return {"err": err, "bound": vote_time_bound(torch, aids),
            **time_vote(torch, aids, w_norm, reps)}


def time_vote(torch, aids, w, reps: int) -> dict:
    """The kernel's device ms warm (the same inputs, in L2) and cold (over
    rotating copies of the inputs, more than 50 MB in all), each by a CUDA
    graph, twice, in turns with the twin's ms by a loop of calls."""
    from otto_tpu_torch.ops import fused_sessions as fs

    warm, cold = warm_cold_ms(torch, fs.aid_vote_aggregate, (aids, w))
    plain_ms = cuda_ms(torch, lambda: fs._vote_reference(aids, w), reps)
    warm2, cold2 = warm_cold_ms(torch, fs.aid_vote_aggregate, (aids, w))
    print(f"vote {list(aids.shape)}: kernel warm {warm:.4f} / {warm2:.4f} ms, cold "
          f"{cold:.4f} / {cold2:.4f} ms (CUDA graphs), twin {plain_ms:.4f} ms", flush=True)
    return {"ms": min(cold, cold2), "warm_ms": min(warm, warm2), "plain_ms": plain_ms}


def vote_on_path(torch, dev, target, served: np.ndarray, chunk: int = 1024) -> dict:
    """Phase 8: the session vote at the shape the aid-weight runner gave it
    in phase 7 (the packed target, one launch).  On the runner's own inputs
    the kernel is held against its twin (run ``chunk`` rows at a time), and
    the runner's lists ``served`` against the twin's ranking: equal wherever
    the twin's neighbouring scores differ by more than twice the row's
    bound.  Then the checks of phase 5 on synthetic rows at [chunk, L].
    Returns the largest ``agg`` error and the times at the path's shape."""
    from otto_tpu_torch import pipelines
    from otto_tpu_torch.models.recency import VALIDATION_COEFFICIENTS
    from otto_tpu_torch.ops import fused_sessions as fs
    from otto_tpu_torch.ops import sessions as ses

    packed = pipelines._packed(target)

    def t(a):
        return torch.as_tensor(a, device=dev)

    mask = t(packed.mask)
    coef = torch.tensor(VALIDATION_COEFFICIENTS, dtype=torch.float32, device=dev)
    w = ses.recency_event_weights(t(packed.aids), t(packed.types), mask, t(packed.lengths), coef)
    aids = torch.where(mask, t(packed.aids), -1).to(torch.int32)
    w = torch.where(mask, w, 0.0)
    S, L = aids.shape
    print(f"aid-weight path's vote input [{S}, {L}], {int(mask.sum())} events, "
          f"{int(mask.sum()) / S:.2f} a session: the kernel scans each row's live prefix",
          flush=True)
    ka, kf, kp = fs.aid_vote_aggregate(aids, w)
    ra, rf, rp = (torch.cat(x) for x in zip(*(
        fs._vote_reference(aids[i:i + chunk], w[i:i + chunk]) for i in range(0, S, chunk))))
    sync(torch, dev)
    check(torch.equal(kf, rf) and torch.equal(kp, rp),
          "vote on the path's inputs: first/firstpos differ from the twin")
    bound = vote_bound(torch, w)
    d = (ka - ra).abs()
    check(bool((d <= bound).all()), "vote on the path's inputs: agg beyond 2^-16 * sum|w|")
    err = d.max().item()

    k = served.shape[1]
    kl, ks = ses._rank_select(aids, torch.where(kf > 0, ka, ses.NEG), kp, k)
    check(np.array_equal(kl.cpu().numpy(), served),
          "the aid-weight runner's lists are not the ranking of the kernel's sums")
    rl, rs = ses._rank_select(aids, torch.where(rf > 0, ra, ses.NEG), rp, min(k + 1, L))
    check(torch.equal(kl >= 0, rl[:, :k] >= 0), "kernel and twin rank different aid counts")
    live = rl[:, :k] >= 0
    check(bool(((ks - rs[:, :k]).abs() <= bound)[live].all()),
          "ranked scores beyond the bound")
    close = (rs[:, 1:] - rs[:, :-1]).abs() <= 2 * bound
    near = torch.zeros_like(rs, dtype=torch.bool)
    near[:, 1:] |= close
    near[:, :-1] |= close
    differ = kl != rl[:, :k]
    check(not bool((differ & ~near[:, :k]).any()), "lists differ away from near-ties")
    print(f"vote on the path's inputs: first/firstpos bit-equal, agg max abs err {err:.3e} "
          f"(limit 2^-16 * sum|w| of the row); the runner's lists equal the twin's ranking "
          f"but {int(differ.any(dim=1).sum())} of {S} rows (near-ties)", flush=True)

    err = max(err, compare_vote(torch, dev, chunk, L, n_cpu=512, reps=0)["err"])
    return {"err": err, "shape": (S, L), "bound": vote_time_bound(torch, aids),
            **time_vote(torch, aids, w, 5)}


def tables_match(got, want) -> tuple[int, int]:
    """Covisitation tables of the port against the reference's: the six
    integer-weighted kinds bit-equal; ``time_weighted`` weights within 1e-5
    relative and its ids equal wherever the row's adjacent weights differ by
    more than 1e-5 relative.  Returns (ids that differ at near-ties, live
    entries) of ``time_weighted``."""
    from otto_tpu_torch.config import COVISIT_KINDS

    swapped = live = 0
    for kind in COVISIT_KINDS:
        (ga, gw), (wa, ww) = got.tables[kind], want.tables[kind]
        check(ga.shape == wa.shape and ga.dtype == wa.dtype and gw.dtype == ww.dtype,
              f"{kind}: table shape/dtype")
        if kind != "time_weighted":
            check(np.array_equal(ga, wa) and np.array_equal(gw, ww),
                  f"{kind}: table differs from the committed one")
            continue
        check(bool(np.all(np.abs(gw - ww) <= 1e-5 * np.abs(ww))), f"{kind}: weights beyond 1e-5")
        close = np.abs(np.diff(ww, axis=1)) <= 1e-5 * np.abs(ww[:, 1:])
        near = np.zeros(ww.shape, bool)
        near[:, 1:] |= close
        near[:, :-1] |= close
        differ = ga != wa
        check(not (differ & ~near).any(), f"{kind}: ids differ away from near-ties")
        swapped, live = int(differ.sum()), int((wa >= 0).sum())
    return swapped, live


def covisit_build(torch, dev) -> dict:
    """Phase 6: the bench's covisitation build on the card against the
    committed tables.  Returns its numbers."""
    from otto_tpu_torch.data.splits import split_by_time
    from otto_tpu_torch.data.synthetic import synthetic_events_v2
    from otto_tpu_torch.models.covisitation import CovisitationMatrices, build_covisitation

    art = REPO / "artifacts" / "bench_e2e"
    fit = json.loads((art / "bench_fit.json").read_text())
    t0 = time.perf_counter()
    store = synthetic_events_v2(n_sessions=fit["sessions"], n_aids=fit["aids"], seed=fit["seed"])
    split = split_by_time(store, val_fraction=fit["val_fraction"], seed=fit["seed"])
    data_s = time.perf_counter() - t0
    stats: dict = {}
    t0 = time.perf_counter()
    mats = build_covisitation(split.train, fit["aids"], stats_out=stats, device=dev)
    build_s = time.perf_counter() - t0
    swapped, live = tables_match(mats, CovisitationMatrices.load(art / "covisitation"))
    n_ev = split.train.n_events
    print(f"data {data_s:.2f} s; build_covisitation over {split.train.n_sessions} sessions, "
          f"{n_ev} events, {fit['aids']} aids: {build_s:.2f} s ({n_ev / build_s:.0f} events/s), "
          f"dispatch {stats['dispatch_s']} s, drain {stats['drain_s']} s", flush=True)
    print(f"tables vs artifacts/bench_e2e/covisitation: six kinds bit-equal; time_weighted "
          f"{swapped} of {live} ids swapped at near-ties", flush=True)
    return {"build_s": build_s, "events": n_ev, "split": split, "store": store, "mats": mats,
            "aids": fit["aids"]}


def baselines(torch, dev, n_sessions: int) -> dict:
    """Phase 7: the three runners of ``pipelines`` at full width, then the
    heuristic re-served on the host routes.  The caller zeroes the launch
    counters before and reads them after."""
    from otto_tpu_torch import EVENT_TYPES, pipelines
    from otto_tpu_torch.data.splits import split_by_fraction
    from otto_tpu_torch.data.synthetic import synthetic_events_v2
    from otto_tpu_torch.models.covisitation import (
        covisit_heuristic_predictions, session_unique_counts)
    from otto_tpu_torch.models.frequency import FrequencyStatistics

    t0 = time.perf_counter()
    store = synthetic_events_v2(n_sessions=n_sessions, n_aids=N_AIDS, seed=SEED)
    sp = split_by_fraction(store)
    target = sp.val_input
    print(f"data {time.perf_counter() - t0:.2f} s: {sp.train.n_sessions} train sessions "
          f"({sp.train.n_events} events), {target.n_sessions} target sessions", flush=True)

    built = {}
    build = pipelines.build_covisitation

    def build_and_keep(*args, **kwargs):  # the runner's own build, kept for the re-serve
        t = time.perf_counter()
        built["mats"] = build(*args, **kwargs)
        built["s"] = time.perf_counter() - t
        return built["mats"]

    runs = {}
    pipelines.build_covisitation = build_and_keep
    try:
        for name, run in (
            ("aid_frequency", lambda: pipelines.run_aid_frequency(
                sp.train, target, N_AIDS, sp.val_labels, device=dev)),
            ("aid_weight", lambda: pipelines.run_aid_weight(target, sp.val_labels, device=dev)),
            ("covisitation", lambda: pipelines.run_covisit_heuristic(
                sp.train, target, N_AIDS, sp.val_labels, device=dev)),
        ):
            t = time.perf_counter()
            res = run()
            sync(torch, dev)
            runs[name] = (res, time.perf_counter() - t)
    finally:
        pipelines.build_covisitation = build
    for name, (res, s) in runs.items():
        r = res.report
        for t in EVENT_TYPES:
            p = res.predictions[t]
            check(p.shape == (target.n_sessions, 20) and p.min() >= -1 and p.max() < N_AIDS,
                  f"{name} {t}: prediction shape/range")
        check(0.0 < r.weighted < 1.0 and np.isfinite(r.weighted), f"{name}: weighted recall")
        print(f"{name}: {s:.2f} s ({target.n_sessions / s:.0f} sessions/s), weighted recall@20 "
              f"{r.weighted:.6f} (clicks {r.clicks:.6f}, carts {r.carts:.6f}, orders "
              f"{r.orders:.6f})", flush=True)

    heur = runs["covisitation"][0].predictions
    counts = session_unique_counts(target)
    cov = counts < 20
    print(f"covisitation: build {built['s']:.2f} s inside the runner; routes: {int(cov.sum())} "
          f"covisitation, {int((~cov).sum())} recency sessions", flush=True)
    stats = FrequencyStatistics.compute(sp.train, n_aids=N_AIDS, device=dev)
    top = {t: stats.top_by_type[t] for t in EVENT_TYPES}
    t0 = time.perf_counter()
    again = covisit_heuristic_predictions(target, built["mats"], top, device=dev)
    sync(torch, dev)
    serve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = covisit_heuristic_predictions(target, built["mats"], top, recency_host_f64=True,
                                         covisit_host=True, device=dev)
    host_s = time.perf_counter() - t0
    agree = {}
    for t in EVENT_TYPES:
        check(np.array_equal(again[t], heur[t]), f"heuristic {t}: two device serves differ")
        check(np.array_equal(host[t][cov], heur[t][cov]),
              f"heuristic {t}: covisitation route, device and host differ")
        agree[t] = float((host[t][~cov] == heur[t][~cov]).all(axis=1).mean()) if (~cov).any() \
            else 1.0
    print(f"heuristic serve on the card (build excluded, tables uploaded): {serve_s:.2f} s "
          f"({target.n_sessions / serve_s:.0f} sessions/s); host routes {host_s:.2f} s; "
          f"covisitation route device == host; recency route rows equal to the host's f64 "
          f"route: {agree}", flush=True)
    return {"serve_s": serve_s, "target": target, "train": sp.train, "mats": built["mats"],
            "heur": heur, "aid_weight": runs["aid_weight"][0].predictions["clicks"],
            "store": store, "covisitation_report": runs["covisitation"][0].report}


# What the JAX package's CPU replay of bench.py::e2e_artifact_bench recorded
# for the 8,000 training-disjoint sessions (BENCH_r05.json, "e2e"): rows
# scored by the rankers, the weighted recalls and lift to four decimals, and
# the paired bootstrap (300 draws, seed 0).
REPLAY_SESSIONS = 8000
REPLAY_EXPECTED = {
    "rows": 4_416_000, "weighted": 0.6372, "heuristic": 0.6226, "lift": 0.0145,
    "bootstrap": {"lift": 0.014549, "weighted_a": 0.637178, "weighted_b": 0.622629,
                  "ci95": [0.008279, 0.021078], "p_le_0": 0.0, "boot_mean": 0.014389,
                  "boot_std": 0.003385, "n_sessions": 8000, "n_boot": 300,
                  "significant": True},
}
FOREST_SOURCE = "otto_tpu_torch/csrc/forest_kernels.cu"


def forest_bound(x, pack, edges=None) -> tuple[float, str]:
    """The forest pass's bound on these rows: the rows (uint8 bins, or
    float32 rows with ``edges``, the [F, 256] edges the kernel reads) and the
    model (its slices, as the kernel reads them) read once and the scores
    written once; or its operations at the int32 rate: one for each node step
    (rows x trees x depth), and for float rows 8 compares a value (the edge
    search)."""
    n, F = x.shape
    n_bytes = (x.numel() * x.element_size() + 4 * n + 4 * pack.model.numel()
               + 8 * pack.n_folds)
    ops = float(n) * pack.n_trees * pack.depth
    if edges is not None:
        n_bytes += edges.numel() * 4
        ops += 8.0 * n * F
    return bound(n_bytes, ops, INT32_OPS_PER_S)


def edge_rows(edges: np.ndarray, n: int, seed: int) -> np.ndarray:
    """Float32 rows [n, F] against a model's ``edges`` [F, E]: lognormal
    values, with a third of the cells an edge value, the float above or below
    one, or a special value (NaN, +-inf, +-0.0, denormals, float32 max)."""
    rng = np.random.default_rng(seed)
    F, E = edges.shape
    e = edges[np.arange(F)[None, :], rng.integers(0, E, (n, F))]
    fmax = np.finfo(np.float32).max
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45, -1e-45, 5e-40, -5e-40,
                        1.1754942e-38, fmax, -fmax], np.float32)
    x = rng.lognormal(size=(n, F)).astype(np.float32)
    kind = rng.integers(0, 9, (n, F))
    x = np.where(kind == 0, e, x)
    with np.errstate(over="ignore"):
        x = np.where(kind == 1, np.nextafter(e, np.float32(np.inf)), x)
        x = np.where(kind == 2, np.nextafter(e, np.float32(-np.inf)), x)
    return np.where(kind == 3, special[rng.integers(0, len(special), (n, F))], x)


def forest_twin(torch, x, pack):
    """The fold average of ``_predict_forest_reference`` as
    ``predict_forest`` forms it on a CPU tensor, here on ``x``'s device."""
    from otto_tpu_torch.ops import forest

    acc = None
    for feat, thr, leaf, base in pack.folds():
        r = forest._predict_forest_reference(x, feat, thr, leaf, base, pack.depth)
        acc = r if acc is None else acc + r
    return acc * torch.tensor(np.float32(1.0 / pack.n_folds), device=x.device)


def two_stage_artifacts(sgns=None, matrices=None):
    """The committed artifacts of ``artifacts/bench_e2e`` for the port: the
    covisitation tables the JAX package wrote (or ``matrices``), the three
    GBDT fold models, the training-time settings of meta.json, and ``sgns``
    if given."""
    from otto_tpu_torch.models.covisitation import CovisitationMatrices
    from otto_tpu_torch.models.gbdt import load_ranker_model
    from otto_tpu_torch.twostage import TwoStageArtifacts

    art = REPO / "artifacts" / "bench_e2e"
    meta = json.loads((art / "meta.json").read_text())
    rankers = {n: load_ranker_model(art / f"ranker_{n}.npz") for n in meta["ranker_names"]}
    if matrices is None:
        matrices = CovisitationMatrices.load(art / "covisitation")
    return TwoStageArtifacts(
        matrices=matrices, sgns=sgns, candidates=None,
        rankers=rankers, predictions={}, report=None, max_recall=meta.get("max_recall", {}),
        heuristic_union=meta.get("heuristic_union", True), feature_list=meta["feature_list"])


def two_stage_replay(torch, dev, split, n_eval: int, n_boot: int, zero_counters,
                     read_counters) -> dict:
    """Phase 9: ``bench.py::e2e_artifact_bench`` in artifact mode on the
    port, in its order: the bench's data (``split``), the committed tables
    and fold models, aid features over train + target (against the
    committed ``aid_feats.npz``), the first ``n_eval`` training-disjoint
    sessions, the heuristic on the host routes, ``predict_two_stage`` on the
    card with the launch counters zeroed before and read after, recall,
    lift and the paired bootstrap, printed beside ``REPLAY_EXPECTED`` (the
    caller holds them to it).  On the card the path must make one launch of
    the float-row forest kernel a type and call the host binning
    (``bin_features``) not once.  Returns the path's launches, the forest
    pass's inputs (the float32 rows on the card and the model of each type,
    kept on their way into ``predict_rows``) and the evaluated sessions."""
    from otto_tpu_torch import EVENT_TYPES, streaming
    from otto_tpu_torch.eval.harness import evaluate_predictions, paired_bootstrap_lift
    from otto_tpu_torch.features import compute_aid_features
    from otto_tpu_torch.models import gbdt
    from otto_tpu_torch.models.covisitation import covisit_heuristic_predictions
    from otto_tpu_torch.models.frequency import FrequencyStatistics
    from otto_tpu_torch.models.gbdt import GBDTRankerModel
    from otto_tpu_torch.twostage import predict_two_stage

    art = REPO / "artifacts" / "bench_e2e"
    fit = json.loads((art / "bench_fit.json").read_text())
    n_aids = fit["aids"]
    artifacts = two_stage_artifacts()

    t0 = time.perf_counter()
    aid_feats = compute_aid_features(streaming._union_stats_store(split.train, split.val_input),
                                     n_aids)
    feats_s = time.perf_counter() - t0
    worst, worst_key, differ = 0.0, None, []
    with np.load(art / "aid_feats.npz") as z:
        check(set(z.files) == set(aid_feats), "aid feature names differ from aid_feats.npz")
        for k in sorted(z.files):
            a, b = aid_feats[k], z[k]
            check(np.array_equal(np.isnan(a), np.isnan(b)), f"aid feature {k}: NaN pattern")
            fin = ~np.isnan(b)
            with np.errstate(divide="ignore", invalid="ignore"):
                rel = float(np.max(np.abs(a[fin] - b[fin]) / np.abs(b[fin]), initial=0.0,
                                   where=b[fin] != 0))
            rel = max(rel, float(np.max(np.abs(a[fin]), initial=0.0, where=b[fin] == 0)))
            if rel > 0:
                differ.append(f"{k} {rel:.3e}")
            if rel >= worst:
                worst, worst_key = rel, k
    print(f"aid features over train + target ({len(aid_feats)} keys, {feats_s:.2f} s) vs "
          f"artifacts/bench_e2e/aid_feats.npz: NaN in the same places; largest relative "
          f"difference {worst:.3e} ({worst_key}); keys that differ: "
          f"{', '.join(differ) if differ else 'none'}", flush=True)
    check(worst <= 1e-6, f"aid features: relative difference {worst} ({worst_key})")

    S = split.val_input.n_sessions
    fit_idx = streaming.train_subset_indices(S, fit["train_sessions"], fit["train_subset_seed"])
    pool = np.ones(S, bool)
    pool[fit_idx] = False
    eval_idx = np.flatnonzero(pool)[:n_eval]
    emask = np.zeros(S, bool)
    emask[eval_idx] = True
    sub = split.val_input.select_sessions(emask)
    sub_labels = split.val_labels.take(eval_idx)

    t0 = time.perf_counter()
    stats = FrequencyStatistics.compute(split.train, n_aids=n_aids, device=dev)
    heur = covisit_heuristic_predictions(
        sub, artifacts.matrices, {t: stats.top_by_type[t] for t in EVENT_TYPES},
        chunk_sessions=512, recency_host_f64=True, covisit_host=True, device=dev)
    heur_s = time.perf_counter() - t0

    captured, host_binning = [], []
    real, real_bin = GBDTRankerModel.predict_rows, gbdt.bin_features

    def keep_inputs(self, x, stats=None):  # the path's own forest inputs, kept
        captured.append((x, self))
        return real(self, x, stats)

    def count_binning(*args):  # host binning calls on the path
        host_binning.append(1)
        return real_bin(*args)

    pstats: dict = {}
    GBDTRankerModel.predict_rows, gbdt.bin_features = keep_inputs, count_binning
    try:
        zero_counters()
        t0 = time.perf_counter()
        preds = predict_two_stage(artifacts, split.train, sub, n_aids, aid_feats=aid_feats,
                                  heuristic_preds=heur, chunk_sessions=512, stats_out=pstats,
                                  device=dev)
        sync(torch, dev)
        predict_s = time.perf_counter() - t0
        launches = read_counters("two-stage path", ("predict_forest_rows",))
    finally:
        GBDTRankerModel.predict_rows, gbdt.bin_features = real, real_bin
    rows = sum(v for k, v in pstats.items() if k.startswith("rows_"))
    print(f"predict_two_stage on {sub.n_sessions} training-disjoint sessions: {predict_s:.2f} s "
          f"({sub.n_sessions / predict_s:.0f} sessions/s, {rows / predict_s:.0f} ranker rows/s); "
          f"{rows} ranker rows", flush=True)
    print("stages (s): " + ", ".join(
        f"{k[:-2]} {pstats[k]:.3f}" for k in ("candidates_s", "union_s", "features_s",
                                               "binning_s", "forest_s", "blend_s"))
          + f"; heuristic on the host routes (given to the path) {heur_s:.3f}", flush=True)

    for t in EVENT_TYPES:
        p = preds[t]
        check(p.shape == (sub.n_sessions, 20) and p.min() >= -1 and p.max() < n_aids,
              f"two-stage {t}: prediction shape/range")
    rep = evaluate_predictions(sub_labels, preds["clicks"], preds["carts"], preds["orders"],
                               device=dev)
    heur_rep = evaluate_predictions(sub_labels, heur["clicks"], heur["carts"], heur["orders"],
                                    device=dev)
    boot = paired_bootstrap_lift(sub_labels, preds, heur, n_boot=n_boot)
    got = {"rows": rows, "weighted": round(rep.weighted, 4),
           "heuristic": round(heur_rep.weighted, 4),
           "lift": round(rep.weighted - heur_rep.weighted, 4), "bootstrap": boot}
    print(f"weighted recall@20 {rep.weighted:.6f} (clicks {rep.clicks:.6f}, carts "
          f"{rep.carts:.6f}, orders {rep.orders:.6f}); heuristic {heur_rep.weighted:.6f}; lift "
          f"{rep.weighted - heur_rep.weighted:+.6f}; paired bootstrap {json.dumps(boot)}",
          flush=True)
    same = {k: got[k] == v for k, v in REPLAY_EXPECTED.items()}
    print(f"against BENCH_r05.json's CPU replay (rows, recalls and lift to four decimals, the "
          f"bootstrap): equal {same} (held to it once phase 9's other checks have run)",
          flush=True)
    print(f"host binning calls on the path: {len(host_binning)}", flush=True)
    check(len(captured) == 3 and not host_binning
          and (dev.type != "cuda" or launches["predict_forest_rows"] == 3),
          "the path did not make one float-row forest launch a type without host binning")
    forest_inputs = [(x, m) for x, m in captured]
    return {"launches": launches, "forest_inputs": forest_inputs, "artifacts": artifacts,
            "replay": got, "sub": sub, "heur": heur, "aid_feats": aid_feats,
            "n_aids": n_aids}


def two_stage_parity(torch, dev, split, replay: dict, n_parity: int) -> None:
    """Phase 9: on the first ``n_parity`` replay sessions, the card's lists
    equal those of the port's CPU twin path (kernels' plain twins, the same
    numpy host stages), bit for bit.  (Not the full run's lists: the
    per-candidate-aid interaction features aggregate over the sessions
    scored together.)"""
    from otto_tpu_torch import EVENT_TYPES
    from otto_tpu_torch.twostage import predict_two_stage

    sub = replay["sub"]
    keep = np.zeros(sub.n_sessions, bool)
    keep[:n_parity] = True
    part = sub.select_sessions(keep)
    heur = {t: h[:n_parity] for t, h in replay["heur"].items()}
    kw = dict(aid_feats=replay["aid_feats"], heuristic_preds=heur, chunk_sessions=512)
    t0 = time.perf_counter()
    on_card = predict_two_stage(replay["artifacts"], split.train, part, replay["n_aids"],
                                device=dev, **kw)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = predict_two_stage(replay["artifacts"], split.train, part, replay["n_aids"],
                               device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    for t in EVENT_TYPES:
        check(np.array_equal(on_card[t], on_cpu[t]), f"two-stage {t}: card and CPU twin differ")
    print(f"{n_parity} sessions: the card's lists equal the CPU twin path's, bit for bit "
          f"(card {card_s:.2f} s, CPU {cpu_s:.2f} s)", flush=True)


def prebinned_path(torch, dev, replay: dict, zero_counters, read_counters) -> dict:
    """Phase 9: the uint8 entry of the forest kernel through its user entry
    point: the clicks rows of the replay binned by the host's numpy
    ``bin_features`` (``GBDTRankerModel.bin``, the JAX package's API) and
    scored by ``predict_binned_folds`` on the card, counters zeroed before
    and read after.  The host's bins must equal the card twin's binning of
    the same rows, and the scores the float-row kernel's.  Returns the
    launches."""
    from otto_tpu_torch.ops import forest

    x, model = replay["forest_inputs"][0]
    t0 = time.perf_counter()
    host_bins = model.bin(x.cpu().numpy())
    bin_s = time.perf_counter() - t0
    check(np.array_equal(host_bins, forest._bin_rows_reference(x, model.packed_edges(dev))
                         .cpu().numpy()), "numpy bin_features and the twin's binning differ")
    zero_counters()
    got = model.predict_binned_folds(host_bins, device=dev)
    sync(torch, dev)
    launches = read_counters("pre-binned scoring path", ("predict_forest",))
    want = model.predict_rows(x).cpu().numpy()
    check(np.array_equal(got.view(np.int32), want.view(np.int32)),
          "predict_binned_folds on numpy bins and the float-row kernel differ")
    print(f"pre-binned path, clicks [{x.shape[0]} x {x.shape[1]}]: numpy bin_features "
          f"{bin_s:.2f} s on the host, equal to the twin's binning on the card; "
          f"predict_binned_folds equal to the float-row kernel, bit for bit", flush=True)
    return launches


def forest_vs_twin(torch, dev, replay: dict) -> list[dict]:
    """Phase 9: the forest kernel against its twins on the path's own float32
    rows of each type: the float-row entry against the twin's binning
    (``torch.searchsorted``) and routing, the uint8 entry against the
    routing twin on the same rows binned, all bit-equal; then on rows of
    edge values and special values for each model.  Times (CUDA events over
    a loop of calls, and a CUDA graph: device time alone) of both entries,
    the twins, the twin's binning alone (``torch.searchsorted``, context for
    the kernel's staging) and the bounds.  Returns the records of both
    entries (at the clicks launch, the largest model)."""
    from otto_tpu_torch import EVENT_TYPES
    from otto_tpu_torch.ops import forest

    recs: dict = {}
    for etype, (x, model) in zip(EVENT_TYPES, replay["forest_inputs"]):
        pack, edges = model.packed(dev), model.packed_edges(dev)
        binned = forest._bin_rows_reference(x, edges)
        r = forest_twin(torch, binned, pack)
        k_rows, k_bins = forest.predict_forest_rows(x, edges, pack), forest.predict_forest(binned,
                                                                                          pack)
        sync(torch, dev)
        for name, k in (("float-row", k_rows), ("uint8", k_bins)):
            check(torch.equal(k.view(torch.int32), r.view(torch.int32)),
                  f"forest kernel ({name} entry) {etype}: differs from its twin on the path's "
                  "rows")
        xe = torch.as_tensor(edge_rows(model.edges, 100_000, SEED + 20), device=dev)
        be = forest._bin_rows_reference(xe, edges)
        check(np.array_equal(be.cpu().numpy(), model.bin(xe.cpu().numpy())),
              f"{etype}: the twin's binning of edge rows differs from numpy bin_features")
        ke, re_ = forest.predict_forest_rows(xe, edges, pack), forest_twin(torch, be, pack)
        sync(torch, dev)
        check(torch.equal(ke.view(torch.int32), re_.view(torch.int32)),
              f"forest kernel (float-row entry) {etype}: differs from its twin on edge rows")
        err = max((k_rows - r).abs().max().item(), (ke - re_).abs().max().item())
        del xe, be, ke, re_
        calls = {"float-row": (lambda: forest.predict_forest_rows(x, edges, pack),
                               lambda: forest_twin(torch, forest._bin_rows_reference(x, edges),
                                                   pack), forest_bound(x, pack, edges)),
                 "uint8": (lambda: forest.predict_forest(binned, pack),
                           lambda: forest_twin(torch, binned, pack), forest_bound(binned, pack))}
        if dev.type == "cuda":
            search_ms = cuda_ms(torch, lambda: forest._bin_rows_reference(x, edges), 3)
        else:  # a rehearsal on the CPU
            search_ms = _host_ms(lambda: forest._bin_rows_reference(x, edges), 1)
        for name, (kernel, twin, b) in calls.items():
            if dev.type == "cuda":
                loop = cuda_ms(torch, kernel, 10)
                dev_ms = graph_ms(torch, [kernel])
                plain = cuda_ms(torch, twin, 1)
            else:
                loop = dev_ms = _host_ms(kernel, 1)
                plain = _host_ms(twin, 1)
            print(f"forest {etype} {name} entry [{x.shape[0]} x {x.shape[1]}], "
                  f"{pack.n_folds} folds, {pack.n_trees} trees of depth {pack.depth}: bit-equal "
                  f"to its twin (and on 100,000 edge-value rows); kernel {loop:.4f} ms (loop) / "
                  f"{dev_ms:.4f} ms (CUDA graph), twin {plain:.3f} ms; bound {b[0]:.4f} ms "
                  f"({b[1]}): {100 * b[0] / dev_ms:.1f}% of it", flush=True)
            rec = recs.get(name)
            if rec is None:
                recs[name] = {
                    "name": "predict_forest_rows" if name == "float-row" else "predict_forest",
                    "route": "cuda", "source": FOREST_SOURCE,
                    "replaces": ("otto_tpu/models/gbdt.py:334 (XLA, not Pallas) with the numpy "
                                 "bin_features of :80" if name == "float-row" else
                                 "otto_tpu/models/gbdt.py:334 (XLA, not Pallas)"),
                    "launches": 0, "max_abs_err": err, "ms": dev_ms, "plain_ms": plain,
                    "bound_ms": b[0], "bound_by": b[1], "library_ms": None}
            recs[name]["max_abs_err"] = max(recs[name]["max_abs_err"], err)
        print(f"forest {etype}: the twin's binning alone (torch.searchsorted on the card, "
              f"context for the kernel's staging) {search_ms:.4f} ms", flush=True)
    return [recs["uint8"], recs["float-row"]]


def two_stage_knn(torch, dev, model, base: dict, n_sessions: int, zero_counters,
                  read_counters) -> dict:
    """Phase 9: ``predict_two_stage`` with an SGNS model in the artifacts, so
    the candidates take the kNN route.  At the bench's 20,000 aids the
    neighbor table takes the dense route in both packages (a table of at
    most 4 x 16,384 padded items is scored by one matmul, no stage 1), so
    this pass runs on the full catalog: phase 3's seeded 1,855,603 x 32
    model, phase 7's covisitation tables and heuristic lists, and the first
    ``n_sessions`` of phase 7's target, with the committed fold models.  The
    counters are zeroed before and read after: stage 1, the peel and the
    forest pass must all launch.  No equality demand (the table is
    approximate): the path's own table against the exact scan on 256 aids,
    overlap >= 0.99.  Returns the launches."""
    from otto_tpu_torch.ops.retrieval import topk_scan
    from otto_tpu_torch.twostage import predict_two_stage

    n_aids = model.w_in.shape[0]
    artifacts = two_stage_artifacts(sgns=model, matrices=base["mats"])
    keep = np.zeros(base["target"].n_sessions, bool)
    keep[:n_sessions] = True
    sub = base["target"].select_sessions(keep)
    heur = {t: h[:n_sessions] for t, h in base["heur"].items()}
    tables = []
    real = model.neighbor_table

    def keep_table(k, **kw):  # the path's own neighbor table, kept for the check
        tables.append(real(k, **kw))
        return tables[-1]

    pstats: dict = {}
    model.neighbor_table = keep_table
    try:
        zero_counters()
        t0 = time.perf_counter()
        preds = predict_two_stage(artifacts, base["train"], sub, n_aids, heuristic_preds=heur,
                                  chunk_sessions=512, stats_out=pstats, device=dev)
        sync(torch, dev)
        secs = time.perf_counter() - t0
        launches = read_counters("two-stage path with an SGNS model",
                                 ("fused_stage1", "peel_rows", "predict_forest_rows"))
    finally:
        del model.neighbor_table
    rows = sum(v for k, v in pstats.items() if k.startswith("rows_"))
    for t, p in preds.items():
        check(p.shape == (n_sessions, 20) and p.min() >= -1 and p.max() < n_aids,
              f"two-stage with SGNS {t}: prediction shape/range")
    table = tables[0]
    sample = np.random.default_rng(SEED + 10).choice(n_aids, 256, replace=False)
    _, ei = topk_scan(model.w_in[torch.as_tensor(sample, device=dev)], model.w_in, k=21,
                      metric="euclidean")
    ei = ei.cpu().numpy()
    exact = np.stack([r[r != a][:20] for r, a in zip(ei, sample)])
    rec = overlap(table[sample], exact)
    print(f"predict_two_stage with a {n_aids} x {model.w_in.shape[1]} SGNS model over "
          f"{n_sessions} sessions ({rows} ranker rows): {secs:.2f} s, of which candidates "
          f"(the neighbor table included) {pstats['candidates_s']:.2f}, features "
          f"{pstats['features_s']:.2f}, binning {pstats['binning_s']:.2f}, forest "
          f"{pstats['forest_s']:.3f}; its neighbor table (k=20) vs the exact scan on 256 aids: "
          f"overlap {rec:.4f} (limit 0.99)", flush=True)
    check(rec >= 0.99, f"two-stage SGNS neighbor-table overlap {rec} < 0.99")
    return launches


# ------------------------------------------------------------- phase 10
TYPE_NAMES = ("clicks", "carts", "orders")


def write_jsonl(store, path: Path) -> None:
    """``store`` as a raw OTTO ``.jsonl`` (one line a session, timestamps in
    milliseconds: the store's seconds times 1000 plus a deterministic
    0-999, which ``read_jsonl(ts_unit="ms")`` drops again)."""
    ms = store.ts.astype(np.int64) * 1000 + (np.arange(store.n_events) * 7919) % 1000
    aid, typ, off = store.aid.tolist(), store.type.tolist(), store.offsets.tolist()
    ms = ms.tolist()
    with open(path, "w") as f:
        for s, sid in enumerate(store.session_ids.tolist()):
            events = ", ".join(f'{{"aid": {aid[i]}, "ts": {ms[i]}, "type": "{TYPE_NAMES[typ[i]]}"}}'
                               for i in range(off[s], off[s + 1]))
            f.write(f'{{"session": {sid}, "events": [{events}]}}\n')


def same_store(a, b) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("session_ids", "offsets", "session_idx", "aid", "ts", "type"))


def head_sessions(store, n: int):
    keep = np.zeros(store.n_sessions, bool)
    keep[:n] = True
    return store.select_sessions(keep)


def submission_lists(sub: dict, session_ids) -> dict:
    """A read-back submission as [S, 20] int32 arrays in ``session_ids``'
    order."""
    out = {}
    for t in TYPE_NAMES:
        rows = [sub[t][int(s)] for s in session_ids]
        out[t] = np.full((len(rows), 20), -1, np.int32)
        for i, r in enumerate(rows):
            out[t][i, :len(r)] = r
    return out


def report_fields(r) -> dict:
    return {f: getattr(r, f) for f in ("clicks", "carts", "orders", "weighted",
                                       "corpus_weighted", "clicks_n", "carts_n", "orders_n")}


@contextlib.contextmanager
def wrapped(module, name: str, wrapper):
    """``module.name`` replaced by ``wrapper(original)`` inside the block."""
    real = getattr(module, name)
    setattr(module, name, wrapper(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def cli_files(torch, dev, store, workdir: Path) -> dict:
    """Phase 10a: phase 7's store written as a raw OTTO ``.jsonl`` and as
    parquet, both read back (the native parser; ``EventStore.from_parquet``)
    and held equal to it."""
    from otto_tpu_torch.data.events import EventStore
    from otto_tpu_torch.data.ingest import read_jsonl

    jsonl, parquet = workdir / "events.jsonl", workdir / "events.parquet"
    t0 = time.perf_counter()
    write_jsonl(store, jsonl)
    write_s = time.perf_counter() - t0
    store.to_parquet(parquet)
    read_jsonl(jsonl)  # builds the native parser once, outside the timed parse
    t0 = time.perf_counter()
    from_jsonl = read_jsonl(jsonl)
    parse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    from_parquet = EventStore.from_parquet(parquet)
    parquet_s = time.perf_counter() - t0
    check(same_store(from_jsonl, store), "the .jsonl read back differs from the store")
    check(same_store(from_parquet, store), "the parquet read back differs from the store")
    mb = jsonl.stat().st_size / 1e6
    print(f"{store.n_sessions} sessions, {store.n_events} events: .jsonl {mb:.1f} MB written in "
          f"{write_s:.2f} s; read_jsonl (native) {parse_s:.3f} s ({store.n_events / parse_s:.0f} "
          f"events/s, {mb / parse_s:.0f} MB/s); from_parquet {parquet_s:.3f} s; both equal to "
          "the store", flush=True)
    return {"jsonl": jsonl, "parquet": parquet, "parse_s": parse_s,
            "events_per_s": store.n_events / parse_s}


def cli_covisitation(torch, dev, files: dict, phase7_report) -> None:
    """Phase 10b: ``covisitation validation`` on the ``.jsonl``; its defaults
    (``--val-fraction 0.1 --seed 42``) are ``split_by_fraction``'s, so its
    report equals phase 7's heuristic report field for field."""
    from otto_tpu_torch import pipelines

    t0 = time.perf_counter()
    res = pipelines.main(["covisitation", "validation", "--events", str(files["jsonl"]),
                          "--n-aids", str(N_AIDS), "--device", dev.type])
    secs = time.perf_counter() - t0
    got, want = report_fields(res.report), report_fields(phase7_report)
    print(f"CLI covisitation validation on the .jsonl: {secs:.2f} s; report {got}", flush=True)
    check(got == want, f"CLI covisitation report {got} differs from phase 7's {want}")
    print("its report equals phase 7's, field for field", flush=True)


def cli_aid_weight(torch, dev, files: dict, store, workdir: Path, zero_counters,
                   read_counters) -> dict:
    """Phase 10c: ``aid_weight submission`` on the parquet (counters zeroed
    before, read after: the session vote launches); the file read back
    equals ``run_aid_weight(store, None)``'s lists.  Returns the launches and
    the writer's rate."""
    from otto_tpu_torch import pipelines
    from otto_tpu_torch.data import submission

    out = workdir / "aid_weight.csv.gz"
    writes = []

    def timed(real):
        def write(*args, **kwargs):
            t = time.perf_counter()
            real(*args, **kwargs)
            writes.append(time.perf_counter() - t)
        return write

    with wrapped(submission, "write_submission", timed):
        zero_counters()
        t0 = time.perf_counter()
        pipelines.main(["aid_weight", "submission", "--events", str(files["parquet"]),
                        "--output", str(out), "--device", dev.type])
        sync(torch, dev)
        secs = time.perf_counter() - t0
        launches = read_counters("CLI aid_weight submission", ("aid_vote",))
    rows = 3 * store.n_sessions
    print(f"CLI aid_weight submission: {secs:.2f} s; write_submission (native) {writes[0]:.3f} "
          f"s for {rows} rows ({rows / writes[0]:.0f} rows/s, {out.stat().st_size / 1e6:.1f} "
          "MB)", flush=True)
    want = pipelines.run_aid_weight(store, None, device=dev).predictions
    got = submission_lists(submission.read_submission(out), store.session_ids)
    for t in TYPE_NAMES:
        check(np.array_equal(got[t], want[t]), f"CLI aid_weight submission {t}: the file "
              "differs from run_aid_weight's lists")
    print("read_submission of the file equals run_aid_weight(store, None)'s lists", flush=True)
    return {"launches": launches, "rows_per_s": rows / writes[0]}


def two_stage_argv(events: Path, adir: Path, device: str) -> list[str]:
    return ["two_stage", "validation", "--ranker", "gbdt", "--n-aids", "20000",
            "--val-fraction", "0.5", "--seed", "0", "--artifact-dir", str(adir),
            "--events", str(events), "--device", device]


def cli_two_stage(torch, dev, bench_store, workdir: Path, zero_counters, read_counters) -> dict:
    """Phase 10d: ``two_stage validation --ranker gbdt`` on phase 6's store
    cut to its first 20,000 sessions (10,000 target sessions), resuming
    from a copy of ``artifacts/bench_e2e``: counters zeroed before, read
    after (one float-row forest launch a type, no more); the lists it saves
    equal ``predict_two_stage`` on the same train and target with the
    artifacts loaded from the committed directory.  Returns the launches."""
    from otto_tpu_torch import pipelines, twostage
    from otto_tpu_torch.data.splits import split_by_fraction

    art = REPO / "artifacts" / "bench_e2e"
    store = head_sessions(bench_store, 20_000)
    events, adir = workdir / "bench_20k.parquet", workdir / "bench_e2e_10d"
    store.to_parquet(events)
    shutil.copytree(art, adir)
    stats: dict = {}
    runs = []

    def with_stats(real):  # the stage seconds, and the artifacts for report_disjoint
        def run(*args, **kwargs):
            runs.append(real(*args, stats_out=stats, **kwargs))
            return runs[-1]
        return run

    with wrapped(twostage, "run_two_stage", with_stats):
        zero_counters()
        t0 = time.perf_counter()
        res = pipelines.main(two_stage_argv(events, adir, dev.type))
        sync(torch, dev)
        secs = time.perf_counter() - t0
        launches = read_counters("CLI two_stage validation", ("predict_forest_rows",))
    check(dev.type != "cuda" or launches["predict_forest_rows"] == 3,
          f"CLI two_stage made {launches['predict_forest_rows']} float-row forest launches, not 3")
    sp = split_by_fraction(store, val_fraction=0.5, seed=0)
    S = sp.val_input.n_sessions
    disjoint = runs[0].report_disjoint
    print(f"CLI two_stage validation: {S} target sessions, {secs:.2f} s ({S / secs:.0f} "
          f"sessions/s); weighted recall@20 {res.report.weighted:.6f} (clicks "
          f"{res.report.clicks:.6f}, carts {res.report.carts:.6f}, orders "
          f"{res.report.orders:.6f}); report_disjoint ({int((~runs[0].selection_mask).sum())} "
          f"sessions) {report_fields(disjoint)}; stages (s): "
          + ", ".join(f"{k[:-2]} {v:.3f}" for k, v in stats.items()), flush=True)
    with np.load(adir / "predictions.npz") as z:
        saved = {t: z[t] for t in TYPE_NAMES}
    meta = json.loads((adir / "meta.json").read_text())
    print(f"saved meta.json max_recall {meta['max_recall']}", flush=True)
    t0 = time.perf_counter()
    want = twostage.predict_two_stage(two_stage_artifacts(), sp.train, sp.val_input, 20_000,
                                      device=dev)
    predict_s = time.perf_counter() - t0
    for t in TYPE_NAMES:
        differ = int((saved[t] != want[t]).any(axis=1).sum())
        check(np.array_equal(saved[t], res.predictions[t]), f"CLI two_stage {t}: saved lists "
              "differ from the returned ones")
        check(differ == 0, f"CLI two_stage {t}: {differ} sessions' saved lists differ from "
              "predict_two_stage's")
    print(f"the saved lists equal predict_two_stage's on the same train and target "
          f"({predict_s:.2f} s)", flush=True)
    return {"launches": launches, "sessions_per_s": S / secs}


def cli_card_vs_cpu(torch, dev, bench_store, workdir: Path) -> None:
    """Phase 10e: the same ``two_stage validation`` command at 500 target
    sessions with ``--device cuda`` and with ``--device cpu``.  The lists
    must be bit-equal.  On the CPU the heuristic takes the host float64
    routes and on the card the device routes, as the JAX package does on a
    CPU and on a TPU; the device recency route may order near-tied aids
    otherwise (ROADMAP §3).  So where the lists differ, each run's heuristic
    lists are compared: every differing heuristic row must be a
    recency-route session, and the CPU path given the card's heuristic lists
    must give the card's lists bit for bit; the rows and aids are printed."""
    from otto_tpu_torch import pipelines, twostage
    from otto_tpu_torch.data.splits import split_by_fraction
    from otto_tpu_torch.models.covisitation import session_unique_counts

    art = REPO / "artifacts" / "bench_e2e"
    store = head_sessions(bench_store, 1_000)
    events = workdir / "bench_1k.parquet"
    store.to_parquet(events)
    runs, heur = [], []  # the card's run, then the CPU's

    def keep(real):
        def lists(*args):
            heur.append(real(*args))
            return heur[-1]
        return lists

    for device in (dev.type, "cpu"):
        adir = workdir / f"bench_e2e_10e_{len(runs)}"
        shutil.copytree(art, adir)
        with wrapped(twostage, "_heuristic_lists", keep):
            t0 = time.perf_counter()
            runs.append(pipelines.main(two_stage_argv(events, adir, device)).predictions)
            print(f"CLI two_stage validation at 500 target sessions, --device {device}: "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
    card, cpu = runs
    differ = {t: np.flatnonzero((card[t] != cpu[t]).any(axis=1)) for t in TYPE_NAMES}
    if not any(len(r) for r in differ.values()):
        print("card and CPU lists bit-equal", flush=True)
        return
    sp = split_by_fraction(store, val_fraction=0.5, seed=0)
    recency = session_unique_counts(sp.val_input) >= 20
    print(f"card and CPU lists differ in sessions {({t: r.tolist() for t, r in differ.items()})}",
          flush=True)
    for t in TYPE_NAMES:
        rows = np.flatnonzero((heur[0][t] != heur[1][t]).any(axis=1))
        for r in rows:
            print(f"  heuristic {t} session {r} (recency route {bool(recency[r])}): card "
                  f"{heur[0][t][r].tolist()} cpu {heur[1][t][r].tolist()}", flush=True)
        check(bool(recency[rows].all()), f"heuristic {t}: card and CPU differ on a "
              "covisitation-route session")
    adir = workdir / "bench_e2e_10e_cpu_given"
    shutil.copytree(art, adir)
    given = twostage.run_two_stage(sp.train, sp.val_input, 20_000, labels=sp.val_labels,
                                   artifact_dir=adir, heuristic_preds=heur[0],
                                   device="cpu").predictions
    for t in TYPE_NAMES:
        check(np.array_equal(given[t], card[t]), f"two_stage {t}: with the card's "
              "heuristic lists the CPU path differs from the card")
    print("cause: the heuristic's recency route differs by route in the sessions above (the "
          "card's device route sums float32 weights, the CPU's host route float64 ones, so "
          "near-tied aids may change places; models/heuristic_host.py's docstring); given the "
          "card's heuristic lists, the CPU path's lists equal the card's bit for bit",
          flush=True)


def cli_subprocess(torch, dev, bench_store, workdir: Path) -> None:
    """Phase 10f: ``python -m otto_tpu_torch.pipelines aid_frequency
    submission ... --device cuda`` in a process of its own: exit 0 and a
    readable file with a row a session and type."""
    from otto_tpu_torch.data import submission

    store = head_sessions(bench_store, 2_000)
    events, out = workdir / "bench_2k_sub.parquet", workdir / "aid_frequency.csv.gz"
    store.to_parquet(events)
    cmd = [sys.executable, "-m", "otto_tpu_torch.pipelines", "aid_frequency", "submission",
           "--events", str(events), "--n-aids", "20000", "--output", str(out),
           "--device", dev.type]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"{' '.join(cmd)} exited {proc.returncode}:\n{proc.stderr}")
    sub = submission.read_submission(out)
    check(all(len(sub[t]) == store.n_sessions for t in TYPE_NAMES)
          and set(sub["clicks"]) == set(store.session_ids.tolist()),
          "the subprocess's submission does not hold a row a session and type")
    print(f"python -m otto_tpu_torch.pipelines aid_frequency submission --device {dev.type}: exit 0 "
          f"in {secs:.2f} s; {out.stat().st_size / 1e6:.2f} MB, {3 * store.n_sessions} rows "
          f"read back; stdout {proc.stdout.strip()!r}", flush=True)


# ------------------------------------------------------------- phase 11
HIST_SOURCE = "otto_tpu_torch/csrc/hist_kernels.cu"
# The bench refit, as tools/stream_scale_run.py:149-152 builds its GBDTConfig
# for artifacts/BENCH_FIT_r05.json: 20,000 training sessions drawn with seed
# 23, bce, 150 trees, 3 folds, early stop 50, min_data_in_leaf 200,
# selection seed 17 (subsample and colsample at their 0.9 default).
REFIT_TRAIN_SESSIONS = 20_000
REFIT_STREAM_SESSIONS = 8_000  # phase 9's sessions: the first training-disjoint ones
# The refit as recorded on an H100 with the first histogram kernel (PERF.md
# §6; the same in every run): each type's fold best iterations, and the lift
# with its ci95, printed to six places.  The same bins and integer sums give
# the same forests, so every later kernel must reproduce them.
REFIT_RECORDED = {
    "best": {"clicks": [90, 90, 80], "carts": [30, 50, 60], "orders": [60, 140, 80]},
    "lift": ("+0.010251", ["0.007652", "0.013098"])}


def refit_config():
    from otto_tpu_torch.config import GBDTConfig

    return GBDTConfig(n_trees=150, n_folds=3, early_stopping_rounds=50, min_data_in_leaf=200,
                      loss="bce")


def refit(torch, dev, split, zero_counters, read_counters) -> dict:
    """Phase 11c: ``run_two_stage_streamed`` in training mode on phase 6's
    data with the bench refit's settings and the committed covisitation
    tables: the rankers fit on 20,000 target sessions, then the first 8,000
    training-disjoint sessions stream (phase 9's).  Counters zeroed before,
    read after: the histogram kernel launches and its twin is never called.
    The fits bin on the card: the binning kernel launches, and numpy
    ``fit_bin_edges`` and ``bin_features`` are never called; afterwards each
    type's device edges are held value-equal to numpy ``fit_bin_edges`` on
    the same rows.  Prints the stage seconds, the fits' seconds by function,
    each fold's best iteration beside the committed models', the
    train-subsample report beside ``BENCH_FIT_r05.json``'s, and the lift
    with its paired bootstrap (1,000 draws, seeded); holds the best
    iterations and the lift with its ci95 equal to the recorded refit (the same
    bins, and K5's integer sums, give the same forests), and the ci95 above
    0 and overlapping the committed models' interval on the same sessions
    (``BENCH_r05.json``).  Returns the first clicks fold's ``fit_gbdt``
    inputs (11a, 11b use them), a type's features with their edges (for
    ``bin_rows``'s times), and the launches."""
    from otto_tpu_torch import EVENT_TYPES, streaming, twostage
    from otto_tpu_torch.models import gbdt
    from otto_tpu_torch.ops import hist

    fit_ref = json.loads((REPO / "artifacts" / "BENCH_FIT_r05.json").read_text())
    committed = two_stage_artifacts()
    first_fold, twin_calls, stats = {}, [], {}

    def keep_first(real):  # the first fold's inputs (clicks, fold 0)
        def fit(*args, **kwargs):
            if not first_fold:
                first_fold.update(args=args, val=kwargs["val"])
            return real(*args, **kwargs)
        return fit

    def count_twin(real):
        def twin(*args):
            twin_calls.append(real.__name__)
            return real(*args)
        return twin

    trained = []

    def keep_data(real):  # each type's training data and the edges fitted on it
        def train(data, *args, **kwargs):
            out = real(data, *args, **kwargs)
            trained.append((data, out[0].edges))
            return out
        return train

    def with_stats(real):
        def run(*args, **kwargs):
            return real(*args, stats_out=stats, **kwargs)
        return run

    spent: dict = {}

    def timed(name):  # seconds spent in a function of the fit, the card drained after
        def wrapper(real):
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                out = real(*args, **kwargs)
                sync(torch, dev)
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
                return out
            return call
        return wrapper

    with wrapped(gbdt, "fit_gbdt", keep_first), \
            wrapped(hist, "_build_histogram_reference", count_twin), \
            wrapped(gbdt, "fit_bin_edges", count_twin), \
            wrapped(gbdt, "bin_features", count_twin), \
            wrapped(streaming, "run_two_stage", with_stats), \
            wrapped(gbdt, "fit_bin_edges_rows", timed("edges")), \
            wrapped(gbdt, "bin_rows", timed("binning")), \
            wrapped(gbdt, "_grow_tree", timed("grow")), \
            wrapped(gbdt, "node_histograms", timed("histograms")), \
            wrapped(gbdt.GBDTForest, "predict_binned", timed("oof")), \
            wrapped(twostage, "train_gbdt_ranker", timed("train_gbdt_ranker")), \
            wrapped(twostage, "train_gbdt_ranker", keep_data):
        zero_counters()
        t0 = time.perf_counter()
        res = streaming.run_two_stage_streamed(
            split.train, split.val_input, 20_000, labels=split.val_labels,
            ranker_config=refit_config(), train_sessions=REFIT_TRAIN_SESSIONS,
            shard_sessions=30_000, selection_seed=17, train_subset_seed=23, chunk_sessions=512,
            matrices=committed.matrices, n_boot=1000, max_stream_sessions=REFIT_STREAM_SESSIONS,
            device=dev)
        sync(torch, dev)
        secs = time.perf_counter() - t0
        launches = read_counters("bench refit", ("node_histograms", "bin_rows",
                                                 "predict_forest", "predict_forest_rows"))
    check(not twin_calls, f"the refit called host or twin routes: {sorted(set(twin_calls))} "
          f"({len(twin_calls)} calls)")
    check(launches["bin_rows"] == len(trained) == 3, f"{launches['bin_rows']} binning launches "
          f"for {len(trained)} trained rankers")
    tm = res.timings
    trees = launches["node_histograms"] / refit_config().max_depth
    print(f"run_two_stage_streamed, training mode: {secs:.2f} s; train_s {tm['train_s']} "
          f"({tm['train_sessions']} sessions), stream_s {tm['stream_s']} "
          f"({tm['streamed_sessions']} sessions), global_features_s "
          f"{tm['global_features_s']}; {launches['node_histograms']} histogram launches = "
          f"{trees:.0f} trees grown ({1e3 * stats['train_s'] / max(trees, 1):.1f} ms a tree, "
          f"all of the fit included); run_two_stage stages (s): "
          + ", ".join(f"{k[:-2]} {v:.3f}" for k, v in stats.items()), flush=True)
    rest = spent["train_gbdt_ranker"] - sum(spent[k] for k in ("edges", "binning", "grow", "oof"))
    print(f"the fits (s; each timed call drains the card): train_gbdt_ranker "
          f"{spent['train_gbdt_ranker']:.3f} = upload, edges (fit_bin_edges_rows) "
          f"{spent['edges']:.3f} + binning (bin_rows) {spent['binning']:.3f} + grow "
          f"{spent['grow']:.3f} (of it K5's wrapper {spent['histograms']:.3f}) + OOF "
          f"{spent['oof']:.3f} + the rest (the upload, fold indexing; in fit_gbdt the "
          f"padded copy, gradients, bags, validation routing, MAP@20, reads) {rest:.3f}",
          flush=True)
    for t in EVENT_TYPES:
        got = [f.best_iteration for f in res.artifacts.rankers[t].forests]
        want = [f.best_iteration for f in committed.rankers[t].forests]
        print(f"  {t}: fold best iterations {got} (committed models {want}; the recorded refit "
              f"{REFIT_RECORDED['best'][t]}); fold recalls "
              f"{[round(r, 6) for r in res.artifacts.rankers[t].fold_recalls]}; alpha "
              f"{res.artifacts.rankers[t].prior_alpha}", flush=True)
        check(got == REFIT_RECORDED["best"][t], f"{t}: best iterations {got} differ from the "
              f"recorded refit {REFIT_RECORDED['best'][t]}")
    sub = res.artifacts.report.weighted
    print(f"train-subsample report: weighted {sub:.6f} (BENCH_FIT_r05.json "
          f"{fit_ref['train_subsample_report']['weighted']:.6f}); disjoint half "
          f"{res.artifacts.report_disjoint.weighted:.6f} "
          f"({fit_ref['train_subsample_report_disjoint']['weighted']:.6f}); the candidates' "
          f"ceiling on the training sessions {json.dumps(res.artifacts.max_recall)} "
          f"(BENCH_FIT_r05.json {json.dumps(fit_ref['max_recall_train_subsample'])})",
          flush=True)
    boot = res.bootstrap_vs_heuristic
    want_ci = REPLAY_EXPECTED["bootstrap"]["ci95"]
    print(f"streamed {tm['streamed_sessions']} sessions: weighted {res.report.weighted:.6f}, "
          f"heuristic {res.heuristic_report.weighted:.6f}, lift {res.lift_vs_heuristic:+.6f}; "
          f"paired bootstrap {json.dumps(boot)}; the committed models on the same sessions: "
          f"lift {REPLAY_EXPECTED['bootstrap']['lift']}, ci95 {want_ci} (BENCH_r05.json)",
          flush=True)
    check(tm["streamed_sessions"] == REFIT_STREAM_SESSIONS and boot["n_boot"] == 1000,
          "the refit did not stream phase 9's sessions with 1,000 bootstrap draws")
    lift = (f"{res.lift_vs_heuristic:+.6f}", [f"{c:.6f}" for c in boot["ci95"]])
    check(lift == REFIT_RECORDED["lift"], f"refit lift and ci95 {lift} differ from the "
          f"recorded refit's {REFIT_RECORDED['lift']}")
    check(boot["ci95"][0] > 0, f"refit lift ci95 {boot['ci95']} does not lie above 0")
    check(boot["ci95"][0] <= want_ci[1] and want_ci[0] <= boot["ci95"][1],
          f"refit lift ci95 {boot['ci95']} does not overlap the committed models' {want_ci}")
    for data, edges in trained:  # the device edges against numpy's on the same rows
        t0 = time.perf_counter()
        want = gbdt.fit_bin_edges(data.features[data.mask], refit_config().n_bins)
        check(np.array_equal(edges, want), "the device edges differ from numpy fit_bin_edges "
              f"on the refit's {data.features.shape} features")
        print(f"device edges of {data.features.shape} features ({int(data.mask.sum())} masked "
              f"rows): value-equal to numpy fit_bin_edges ({time.perf_counter() - t0:.2f} s on "
              f"the host; {int((np.signbit(edges) != np.signbit(want)).sum())} edges differ in "
              f"the sign of a zero)", flush=True)
    return {"launches": launches, "fold": first_fold, "train_s": tm["train_s"],
            "stream_s": tm["stream_s"], "lift": boot, "trees": trees, "spent": spent,
            "typed": trained[0]}


def resumed_train_report(torch, dev, split) -> dict:
    """Phase 11c: the committed rankers resumed on the refit's 20,000
    training sessions (seed 23), as ``BENCH_FIT_r05.json``'s run resumed
    them from its ``artifact_dir`` (``artifacts/bench_e2e``): their fold
    average on the sessions they were trained on, the heuristic on the host
    routes.  Held to the JSON's ``train_subsample_report`` per type and to
    the committed ``predictions.npz`` (that run's lists) in every session:
    the JSON's report is this in-sample one, a training run's (11c's) the
    out-of-fold one."""
    from otto_tpu_torch import EVENT_TYPES, streaming
    from otto_tpu_torch.eval.harness import evaluate_predictions
    from otto_tpu_torch.models.covisitation import covisit_heuristic_predictions
    from otto_tpu_torch.models.frequency import FrequencyStatistics
    from otto_tpu_torch.twostage import predict_two_stage

    art = REPO / "artifacts" / "bench_e2e"
    fit = json.loads((art / "bench_fit.json").read_text())
    want = json.loads((REPO / "artifacts" / "BENCH_FIT_r05.json").read_text())
    S = split.val_input.n_sessions
    idx = streaming.train_subset_indices(S, fit["train_sessions"], fit["train_subset_seed"])
    keep = np.zeros(S, bool)
    keep[idx] = True
    sub = split.val_input.select_sessions(keep)
    artifacts = two_stage_artifacts()
    with np.load(art / "aid_feats.npz") as z:
        aid_feats = {k: z[k] for k in z.files}
    t0 = time.perf_counter()
    stats = FrequencyStatistics.compute(split.train, n_aids=fit["aids"], device=dev)
    heur = covisit_heuristic_predictions(
        sub, artifacts.matrices, {t: stats.top_by_type[t] for t in EVENT_TYPES},
        chunk_sessions=512, recency_host_f64=True, covisit_host=True, device=dev)
    preds = predict_two_stage(artifacts, split.train, sub, fit["aids"], aid_feats=aid_feats,
                              heuristic_preds=heur, chunk_sessions=512, device=dev)
    rep = evaluate_predictions(split.val_labels.take(idx), preds["clicks"], preds["carts"],
                               preds["orders"], device="cpu")
    with np.load(art / "predictions.npz") as z:
        same = {t: int((preds[t] == z[t]).all(axis=1).sum()) for t in EVENT_TYPES}
    got = {t: round(getattr(rep, t), 6) for t in EVENT_TYPES}
    ref = {t: round(want["train_subsample_report"][t], 6) for t in EVENT_TYPES}
    print(f"the committed rankers resumed on the refit's {len(idx)} training sessions "
          f"({time.perf_counter() - t0:.2f} s): weighted {rep.weighted:.6f}, {got} "
          f"(BENCH_FIT_r05.json's train-subsample report {ref}); sessions whose lists equal "
          f"the committed predictions.npz: {same}", flush=True)
    check(got == ref, f"the resumed fold average on the training sessions {got} differs from "
          f"BENCH_FIT_r05.json's train-subsample report {ref}")
    check(all(v == len(idx) for v in same.values()),
          f"the resumed lists differ from artifacts/bench_e2e/predictions.npz: {same}")
    return {"weighted": rep.weighted}


def hist_bound(listed: int, n_keys: int, n_feat: int, n_bins: int) -> tuple[float, str]:
    """The histogram's bound on these inputs: each listed row's id (4 bytes),
    vals (12) and bins (one a feature) read once, the float32 histogram
    written once; or its adds (three a listed row and feature) at the float32
    rate."""
    n_bytes = listed * (4 + 12 + n_feat) + 12 * n_keys * n_feat * n_bins
    return bound(n_bytes, 3.0 * listed * n_feat, F32_OPS_PER_S)


def fold_gradients(torch, dev, fold: dict):
    """The first fold's rows on ``dev`` and the gradients of its first
    tree: bce at the boost-from-average base, times the keep weights."""
    from otto_tpu_torch.models import gbdt

    binned, labels, mask, weight, cfg = fold["args"][:5]
    S, C, F = binned.shape
    x = binned.reshape(S * C, F).to(dev)
    p0 = min(max(float((labels * weight).sum()) / max(float(weight.sum()), 1.0), 1e-6), 1 - 1e-6)
    w = torch.as_tensor(weight.reshape(-1), device=dev)
    g, h = gbdt._bce_gh(torch.full((S, C), float(np.log(p0 / (1 - p0))), device=dev),
                        torch.as_tensor(labels, device=dev),
                        torch.as_tensor(weight > 0, device=dev))
    return x, g.reshape(-1) * w, h.reshape(-1) * w, w


def hist_vs_twin(torch, dev, fold: dict) -> dict:
    """Phase 11a: the histogram kernel against its twin on the first clicks
    fold's binned training rows, at the launches of one tree of the fit
    (level 0, the root's row list; levels 1-6, the left children's stretches
    of the list as the tree's own routing splits it), with the fold's bce
    gradients, a bag and the keep weights as the tree hands them over: on
    dyadic vals (k/256) bit-equal to the twin, on the real vals bit-equal to
    the plain fixed-point reference (the kernel's scale rule) and within
    2^-20 of each column's sum of |vals| of the float64 twin, two launches
    bit-identical.  Times (CUDA graph: device time alone) of the kernel (its
    wrapper: the int64 sums and the float32 finish), the twin, ``index_add_``
    in float32 of the listed rows' entries at their flat keys (the one
    PyTorch call that computes the function; timed, used nowhere), the row
    list's split after each level
    (``_split_rows``, torch) and the bound.  Returns the record of the level-0
    launch with the largest error over all levels."""
    from otto_tpu_torch.models import gbdt
    from otto_tpu_torch.ops import hist

    cfg = fold["args"][4]
    x, g, h, w = fold_gradients(torch, dev, fold)
    n, F = x.shape
    gen = torch.Generator().manual_seed(cfg.seed)
    bag = (torch.rand(n, generator=gen) < cfg.subsample).to(device=dev, dtype=torch.float32)
    launches, splits = [], []

    def keep(real):
        def build(*args):
            launches.append(args)
            return real(*args)
        return build

    def keep_split(real):
        def split(*args):
            splits.append(args)
            return real(*args)
        return split

    with wrapped(gbdt, "node_histograms", keep), wrapped(gbdt, "_split_rows", keep_split):
        gbdt._grow_tree(x, g, h, w, bag, torch.ones(F, dtype=torch.bool, device=dev),
                        cfg.reg_lambda, cfg.min_split_gain, cfg.min_data_in_leaf,
                        cfg.min_child_weight, cfg.learning_rate, depth=cfg.max_depth,
                        n_bins=cfg.n_bins)
    print(f"the first clicks fold: {n} rows x {F} features, {cfg.n_bins} bins; one tree's "
          f"{len(launches)} launches", flush=True)
    g_dy = torch.Generator(device=dev).manual_seed(SEED + 11)
    rec, totals = None, np.zeros(5)
    for level, (rows, n_feat, vals, vmax, order, start, pre, n_bins) in enumerate(launches):
        n_keys, listed = start.shape[0], int(pre[-1])
        key = hist.list_keys(order, start, pre, n)
        dyadic = torch.randint(-255, 256, (n, 3), generator=g_dy, device=dev).float() / 256
        for kind, v in (("dyadic", dyadic), ("real", vals)):
            args = (rows, n_feat, v, v.abs().amax(dim=0), order, start, pre, n_bins)
            a = hist.node_histograms(*args)
            b = hist.node_histograms(*args)
            want = hist._build_histogram_reference(x, key, v, n_keys, n_bins)
            sync(torch, dev)
            check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
                  f"histogram level {level} ({kind}): two launches differ")
            if kind == "dyadic":
                check(torch.equal(a, want), f"histogram level {level}: differs from its twin "
                      "on dyadic vals")
            else:
                fixed = hist._fixed_point_histogram(x, key, v, n_keys, n_bins)
                check(torch.equal(a.view(torch.int32), fixed.view(torch.int32)),
                      f"histogram level {level}: differs from the fixed-point reference")
                tol = 2.0 ** -20 * v.abs().sum(dim=0)
                err = (a - want).abs()
                check(bool((err <= tol).all()), f"histogram level {level}: off its twin by "
                      f"{err.amax(dim=(0, 1, 2)).tolist()} > {tol.tolist()}")
                max_err = float(err.max())
                del fixed
        del dyadic, a, b, want
        # index_add_ over the listed rows' (row, feature) entries, the flat
        # keys and vals made before it is timed
        size = n_keys * F * n_bins
        on = torch.nonzero((key >= 0) & (key < n_keys))[:, 0]
        flat = ((key[on].long()[:, None] * F + torch.arange(F, device=dev)) * n_bins
                + x[on].long()).reshape(-1)
        flat_vals = vals[on][:, None, :].expand(-1, F, 3).reshape(-1, 3).contiguous()
        lib_out = torch.zeros((size, 3), device=dev)
        launch = (rows, n_feat, vals, vmax, order, start, pre, n_bins)
        if dev.type == "cuda":
            ms = graph_ms(torch, [lambda: hist.node_histograms(*launch)])
            plain = cuda_ms(torch, lambda: hist._build_histogram_reference(x, key, vals,
                                                                           n_keys, n_bins), 2)
            lib = cuda_ms(torch, lambda: lib_out.zero_().index_add_(0, flat, flat_vals), 3)
            split_ms = (graph_ms(torch, [lambda: gbdt._split_rows(*splits[level])])
                        if level < len(splits) else 0.0)
        else:  # a rehearsal on the CPU
            ms = plain = _host_ms(lambda: hist.node_histograms(*launch), 1)
            lib = _host_ms(lambda: lib_out.zero_().index_add_(0, flat, flat_vals), 1)
            split_ms = (_host_ms(lambda: gbdt._split_rows(*splits[level]), 1)
                        if level < len(splits) else 0.0)
        del on, flat, flat_vals, lib_out
        b_ms, b_by = hist_bound(listed, n_keys, F, n_bins)
        totals += (ms, plain, lib, b_ms, split_ms)
        print(f"  level {level}: {n_keys} keys, {listed} listed rows: bit-equal on dyadic vals "
              f"and to the fixed-point reference, deterministic, largest error against the "
              f"float64 twin on the real vals {max_err:.3e}; kernel {ms:.4f} ms (CUDA graph), "
              f"twin {plain:.3f} ms, index_add_ float32 {lib:.3f} ms; bound {b_ms:.4f} ms "
              f"({b_by}: 16 + {F} bytes a listed row, 12 a cell out; 3 float32 adds a listed "
              f"row and feature at 67e12/s): {100 * b_ms / ms:.1f}% of it; the list's split "
              f"after the level {split_ms:.4f} ms", flush=True)
        if rec is None:
            rec = {"name": "node_histograms", "route": "cuda", "source": HIST_SOURCE,
                   "replaces": "otto_tpu/models/gbdt.py:109 (_mm_hist) and :233-266 (the "
                               "scatter branch); XLA, not Pallas",
                   "launches": 0, "max_abs_err": max_err, "ms": ms, "plain_ms": plain,
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
        rec["max_abs_err"] = max(rec["max_abs_err"], max_err)
    print(f"one tree's {len(launches)} launches: kernel {totals[0]:.3f} ms, twin "
          f"{totals[1]:.3f} ms, index_add_ {totals[2]:.3f} ms, bound {totals[3]:.4f} ms "
          f"({100 * totals[3] / totals[0]:.1f}%); the list's {len(splits)} splits "
          f"{totals[4]:.3f} ms", flush=True)
    rec["tree_ms"], rec["tree_bound_ms"] = float(totals[0]), float(totals[3])
    return rec


def bin_rows_vs_twin(torch, dev, typed) -> dict:
    """Phase 11a: the binning kernel on the refit's clicks features (the
    float32 rows of every candidate of 20,000 sessions) against its edges:
    bit-equal to its twin, and to numpy ``bin_features`` on the first
    200,000 rows; times (CUDA graph) of the kernel, the twin and
    ``torch.searchsorted`` over the transposed rows (the one PyTorch call
    near the function: it leaves out NaN -> 0, the + 1 and the transposes;
    timed, used nowhere), and the bound."""
    from otto_tpu_torch.models import gbdt
    from otto_tpu_torch.ops import forest

    data, edges = typed
    S, C, F = data.features.shape
    x = torch.as_tensor(data.features.reshape(S * C, F), device=dev)
    packed = forest.pack_edges(edges, device=dev)
    got = forest.bin_rows(x, packed)
    want = forest._bin_rows_reference(x, packed)
    sync(torch, dev)
    check(torch.equal(got, want), "bin_rows differs from its twin on the refit's features")
    head = data.features.reshape(S * C, F)[:200_000]
    check(np.array_equal(got[:200_000].cpu().numpy(), gbdt.bin_features(head, edges)),
          "bin_rows differs from numpy bin_features on the refit's features")
    xt = x.T.contiguous()
    if dev.type == "cuda":
        ms = graph_ms(torch, [lambda: forest.bin_rows(x, packed)])
        plain = cuda_ms(torch, lambda: forest._bin_rows_reference(x, packed), 3)
        lib = cuda_ms(torch, lambda: torch.searchsorted(packed, xt), 3)
    else:  # a rehearsal on the CPU
        ms = plain = _host_ms(lambda: forest.bin_rows(x, packed), 1)
        lib = _host_ms(lambda: torch.searchsorted(packed, xt), 1)
    b_ms, b_by = bound(5.0 * x.numel() + packed.numel() * 4, 9.0 * x.numel(), F32_OPS_PER_S)
    print(f"bin_rows on the refit's clicks features [{S * C} x {F}]: bit-equal to its twin "
          f"and to numpy bin_features; kernel {ms:.4f} ms (CUDA graph), twin {plain:.3f} ms, "
          f"torch.searchsorted {lib:.3f} ms; bound {b_ms:.4f} ms ({b_by}: 4 bytes in and 1 "
          f"out a value; 8 compares and a NaN test a value at 67e12/s): "
          f"{100 * b_ms / ms:.1f}% of it", flush=True)
    return {"name": "bin_rows", "route": "cuda", "source": FOREST_SOURCE,
            "replaces": "otto_tpu/models/gbdt.py:80 (bin_features, host numpy; not Pallas)",
            "launches": 0, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib}


def fits_card_vs_cpu(torch, dev, fold: dict, tree_sessions: int = 2_000) -> None:
    """Phase 11b: on the first ``tree_sessions`` sessions of the first
    clicks fold (the CPU twin takes ~18 us a row), one tree on dyadic
    grad/hess (k/1024, |k| <= 7: every histogram cell and cumulative sum is
    exact in float32, so the card and the CPU sum the same numbers):
    ``_grow_tree`` on the card equals the CPU twin's in features,
    thresholds, leaf ids and leaves, bit for bit; a 10-tree bce fit run
    twice on the card gives the same forest; a 5-tree lambdarank fit
    (``configs/gbdt_lambdarank.yaml``, ``n_trees`` cut) at the fold's full
    width, and ``_lambdarank_gh`` on its scores on the card within 1e-5
    relative of the CPU twin."""
    from otto_tpu_torch.config import GBDTConfig
    from otto_tpu_torch.models import gbdt

    rows, labels, mask, weight, cfg = fold["args"][:5]  # the fold's bins, on the card
    binned = rows.cpu().numpy()
    S, C, F = binned.shape
    rng = np.random.default_rng(SEED + 12)
    n = S * C
    nt = min(S, tree_sessions) * C
    host = [binned.reshape(n, F)[:nt], (rng.integers(-7, 8, nt) / 1024).astype(np.float32),
            (rng.integers(1, 8, nt) / 1024).astype(np.float32), weight.reshape(n)[:nt],
            np.ones(nt, np.float32), np.ones(F, bool)]
    scalars = (cfg.reg_lambda, cfg.min_split_gain, cfg.min_data_in_leaf, cfg.min_child_weight,
               cfg.learning_rate)
    kw = dict(depth=cfg.max_depth, n_bins=cfg.n_bins)
    t0 = time.perf_counter()
    card = gbdt._grow_tree(*(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                             for a in host), *scalars, **kw)
    sync(torch, dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = gbdt._grow_tree(*(torch.as_tensor(np.ascontiguousarray(a)) for a in host), *scalars,
                          **kw)
    cpu_s = time.perf_counter() - t0
    for name, a, b in zip(("feat", "thr", "leaf", "gain", "leaf id"), card, cpu):
        check(torch.equal(a.cpu().view(torch.int32), b.view(torch.int32)),
              f"_grow_tree on dyadic grad/hess: {name} differs between the card and the CPU")
    splits = int((card[1] < cfg.n_bins).sum())
    print(f"_grow_tree on dyadic grad/hess, [{nt} x {F}]: card {card_s:.2f} s, CPU twin "
          f"{cpu_s:.2f} s; features, thresholds, leaves, gains and leaf ids bit-equal "
          f"({splits} of {len(card[1])} nodes split)", flush=True)

    val = fold["val"]
    short = GBDTConfig(**{**vars(cfg), "n_trees": 10})
    t0 = time.perf_counter()
    fits = [gbdt.fit_gbdt(rows, labels, mask, weight, short, val=val, device=dev)
            for _ in range(2)]
    fit_s = (time.perf_counter() - t0) / 2
    for name in ("feat", "thr", "leaf", "gain_importance", "split_importance"):
        a, b = getattr(fits[0], name), getattr(fits[1], name)
        check(a.shape == b.shape and a.tobytes() == b.tobytes(),
              f"two 10-tree bce fits on the card differ in {name}")
    print(f"two 10-tree bce fits on the card ({fit_s:.2f} s each): the same forest, bit for "
          f"bit (best iteration {fits[0].best_iteration})", flush=True)

    lcfg = GBDTConfig.from_yaml(REPO / "configs" / "gbdt_lambdarank.yaml")
    lcfg = GBDTConfig(**{**vars(lcfg), "n_trees": 5})
    t0 = time.perf_counter()
    lam = gbdt.fit_gbdt(rows, labels, mask, weight, lcfg, val=val, device=dev)
    lam_s = time.perf_counter() - t0
    scores = lam.predict_binned(rows.reshape(n, F), device=dev).reshape(S, C)
    keep = weight > 0
    on = [torch.as_tensor(a, device=dev) for a in (scores, labels, keep)]
    t0 = time.perf_counter()
    g_card, h_card = gbdt._lambdarank_gh(*on, k=lcfg.lambdarank_k, chunk=lcfg.chunk_sessions)
    sync(torch, dev)
    lr_card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g_cpu, h_cpu = gbdt._lambdarank_gh(*(torch.as_tensor(a) for a in (scores, labels, keep)),
                                       k=lcfg.lambdarank_k, chunk=lcfg.chunk_sessions)
    lr_cpu_s = time.perf_counter() - t0
    worst = 0.0
    for a, b in ((g_card.cpu(), g_cpu), (h_card.cpu(), h_cpu)):
        scale = float(b.abs().max())
        check(bool(torch.allclose(a, b, rtol=1e-5, atol=1e-5 * scale)),
              "_lambdarank_gh on the card is not within 1e-5 relative of the CPU twin")
        worst = max(worst, float((a - b).abs().max()) / scale)
    print(f"5-tree lambdarank fit at [{S} sessions x {C} x {F}]: {lam_s:.2f} s; "
          f"_lambdarank_gh on its scores: card {lr_card_s:.2f} s, CPU {lr_cpu_s:.2f} s, "
          f"largest difference {worst:.2e} of the largest |value|", flush=True)


# 11d's store: phase 6's first sessions (40,000 until phase 17 came, when
# the script took 1,070.58 s of phases on a slower host: cut so that its
# command time stays well under the 1,200 s limit; 24,000 until phase 18
# came; 20,000 until phase 3b's deep stage-1 route came, when it took
# 1,210.5 s of phases on a slow host); the streamed run takes the same
# sessions
CLI_TRAIN_SESSIONS = 10_000


def cli_train(torch, dev, bench_store, workdir: Path, zero_counters, read_counters) -> dict:
    """Phase 11d: ``two_stage validation --ranker gbdt --config <20 trees, 3
    folds, min_data_in_leaf 200, bce>`` on phase 6's store cut to
    CLI_TRAIN_SESSIONS sessions into an empty ``--artifact-dir``: three rankers written, the
    histogram kernel launched.  The same command again resumes: no
    histogram launch, and its lists equal ``predict_two_stage`` with the
    saved artifacts on the same split (the training run's own lists rank
    out-of-fold scores, the resumed run's the fold average, in both
    packages: the sessions where they differ are counted).  Then
    ``two_stage_streamed validation --train-sessions 2500`` on the same
    sessions (half of its target sessions train, half stream): exit 0, a
    lift printed.  Returns the launches."""
    import io

    from otto_tpu_torch import pipelines, twostage
    from otto_tpu_torch.data.splits import split_by_fraction

    store = head_sessions(bench_store, CLI_TRAIN_SESSIONS)
    events, adir, cfg = (workdir / "bench_head.parquet", workdir / "trained",
                         workdir / "gbdt_20.yaml")
    store.to_parquet(events)
    cfg.write_text("n_trees: 20\nn_folds: 3\nmin_data_in_leaf: 200\nloss: bce\n")
    common = ["--ranker", "gbdt", "--config", str(cfg), "--n-aids", "20000", "--val-fraction",
              "0.5", "--seed", "0", "--device", dev.type]
    argv = ["two_stage", "validation", "--artifact-dir", str(adir), "--events", str(events),
            *common]
    zero_counters()
    t0 = time.perf_counter()
    first = pipelines.main(argv)
    sync(torch, dev)
    train_s = time.perf_counter() - t0
    trained = read_counters("CLI two_stage validation, training", ("node_histograms",
                                                                    "bin_rows"))
    saved = sorted(p.name for p in adir.glob("ranker_*.npz"))
    check(saved == [f"ranker_{t}.npz" for t in sorted(TYPE_NAMES)],
          f"the training run saved {saved}")
    zero_counters()
    t0 = time.perf_counter()
    second = pipelines.main(argv)
    sync(torch, dev)
    resume_s = time.perf_counter() - t0
    resumed = read_counters("CLI two_stage validation, resumed", ("predict_forest_rows",))
    check(resumed["node_histograms"] == resumed["bin_rows"] == 0,
          "the resumed run launched the histogram or the binning kernel")
    sp = split_by_fraction(store, val_fraction=0.5, seed=0)
    want = twostage.predict_two_stage(twostage.TwoStageArtifacts.load(adir, device=dev),
                                      sp.train, sp.val_input, 20_000, device=dev)
    for t in TYPE_NAMES:
        check(np.array_equal(second.predictions[t], want[t]), f"the resumed CLI run's {t} "
              "lists differ from predict_two_stage's with the saved artifacts")
    differ = {t: int((first.predictions[t] != second.predictions[t]).any(axis=1).sum())
              for t in TYPE_NAMES}
    print(f"CLI two_stage validation, {sp.val_input.n_sessions} target sessions: training run "
          f"{train_s:.2f} s (weighted {first.report.weighted:.6f}), resumed {resume_s:.2f} s "
          f"(weighted {second.report.weighted:.6f}); the resumed lists equal predict_two_stage "
          f"with the saved artifacts; sessions whose lists differ between the training run "
          f"(out-of-fold scores) and the resumed one (fold average): {differ}", flush=True)
    # the streamed run on the same sessions: half of the target sessions
    # train, half stream
    n_train = sp.val_input.n_sessions // 2
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        streamed = pipelines.main(["two_stage_streamed", "validation", "--train-sessions",
                                   str(n_train), "--events", str(events), *common])
    streamed_s = time.perf_counter() - t0
    lift = [line for line in out.getvalue().splitlines() if line.startswith("lift vs heuristic")]
    check(len(lift) == 1 and 0 < streamed.report.weighted <= 1,
          "two_stage_streamed validation printed no lift")
    print(f"CLI two_stage_streamed validation --train-sessions {n_train} on "
          f"{store.n_sessions} sessions: {streamed_s:.2f} s; "
          f"{lift[0]}; weighted {streamed.report.weighted:.6f}", flush=True)
    return {"launches": trained, "resumed": resumed}


# ------------------------------------------------------------- phase 12
# SGNS training on the card with the published configs
# (configs/fasttext.yaml: dim 32, window 10, negatives 40, subsample 1e-4,
# batch 8,192, 8 steps a call; configs/word2vec.yaml: hs, window 12,
# subsample 3e-3) over the full catalog, cut as SGNS_CUTS says.
# 12e's catalog: the least round count whose table takes the fused route
# (more than 4 x 16,384 padded items), so K1 and K2 launch; the full
# catalog's covisitation tables and aid features would add a minute of
# host work that phases 7 and 9 already drive.
TWO_STAGE_SGNS_AIDS = 100_000
# 12b's corpus and 12e's store (200,000 and 20,000 sessions until phase
# 3b's deep stage-1 route came, when the script took 1,210.5 s of phases on
# a slow host: cut so that its command time stays under the 1,200 s limit)
SGNS_TRAINER_SESSIONS = 100_000
TWO_STAGE_SGNS_SESSIONS = 10_000
SGNS_CUTS = ("epochs 5 -> 1 (each config)",
             "corpus: phase 7's 200,000-session store (2,599,069 events over the "
             "1,855,603-aid catalog), not the OTTO training week; 12b trains on its first "
             f"{SGNS_TRAINER_SESSIONS:,} sessions (the whole store until 3b's deep route came)",
             f"12e: phase 11d's store cut to its first {TWO_STAGE_SGNS_SESSIONS:,} sessions "
             f"(half of them target; 20,000 until 3b's deep route came), over a "
             f"{TWO_STAGE_SGNS_AIDS:,}-aid "
             "catalog")
# 12a: card against CPU, each table entry within STEP_RTOL * (|cpu| +
# STEP_FLOOR) and the loss within LOSS_RTOL relative.  Set from the CPU
# rehearsal on these inputs: float32 against float64 differed by at most
# 8.8e-6 * (|x| + 1e-2) and 1.4e-7 in the loss; the card's atomics add in
# another order, so its distance to the CPU's float32 is up to twice that.
STEP_RTOL, STEP_FLOOR, LOSS_RTOL = 1e-4, 1e-2, 1e-5
# 12b: train_sgns_device's kept pairs against the host epoch's pairs scaled
# to its draws (the same subsample, the same acceptance in expectation).
KEPT_BAND = 0.01
# 12c: a planted-cluster corpus over the full catalog's id space (30 aids a
# cluster, so that an aid's 21 nearest neighbors can all be its own
# cluster's and none is an untrained aid near a tie), 67 events a trained
# aid, and the least share of its trained aids whose top neighbor is in
# their own cluster after one fasttext epoch.  The CPU rehearsal (300
# clusters of 30 over the same catalog, 30,000 sessions of 20 events, one
# epoch, 300 trained aids sampled) measured a share of 1.0 and a recall of
# the compensated retriever's twin against the exact scan of 0.999.
PLANTED = {"clusters": 1000, "per": 30, "sessions": 100_000, "length": 20}
PLANTED_SAME_CLUSTER = 0.95


def sgns_config(name: str, **over):
    """``configs/<name>.yaml`` with one epoch (SGNS_CUTS)."""
    from otto_tpu_torch.config import SGNSConfig

    return SGNSConfig.from_yaml(REPO / "configs" / f"{name}.yaml").replace(epochs=1, **over)


def step_bound(rows_in: np.ndarray, rows_out: np.ndarray, index_bytes: int, D: int,
               flops: float) -> tuple[float, str]:
    """An SGNS step's bound: each distinct row it updates (w_in and acc_in
    at the centers, w_out and acc_out at the output rows) read once and
    written once, float32, plus its index and weight inputs; its float32
    operations over the CUDA cores' rate."""
    n_rows = len(np.unique(rows_in)) + len(np.unique(rows_out))
    return bound(n_rows * D * 4 * 2 * 2 + index_bytes, flops, F32_OPS_PER_S)


def sgns_steps(torch, dev, store, n_aids: int, reps: int = 20) -> list[dict]:
    """Phase 12a: the four SGNS steps at full width, card against CPU on the
    same inputs: one batch of the store's fasttext pairs (duplicated
    centers, contexts that are also negatives), per-pair negatives drawn on
    the host from the store's unigram^0.75 CDF, 1,024 shared ones, weights
    with 40% rejected draws, synthetic Huffman paths of depth 10-24.  Then
    each step's time on the card (CUDA events over ``reps`` steps) against
    its bound."""
    from otto_tpu_torch.models import embeddings as emb

    cfg = sgns_config("fasttext")
    B, N, D, L = cfg.batch_centers, cfg.negatives, cfg.dim, 24
    rng = np.random.default_rng(SEED + 12)
    counts = np.bincount(store.aid, minlength=n_aids).astype(np.float64)
    c, x = emb.skipgram_pairs(store, cfg.window, rng, cfg.subsample_t, counts)
    sel = rng.choice(len(c), B, replace=False)
    host = {"centers": c[sel].astype(np.int64), "contexts": x[sel].astype(np.int64)}
    cdf = emb.negative_cdf(counts, cfg.ns_exponent, device="cpu")
    host["negatives"] = emb.draw_negatives(
        cdf, torch.from_numpy(rng.random((B, N), dtype=np.float32))).numpy()
    host["shared"] = emb.draw_negatives(
        cdf, torch.from_numpy(rng.random(1024, dtype=np.float32))).numpy()
    host["weight"] = (rng.random(B) >= 0.4).astype(np.float32)
    depth = rng.integers(10, L + 1, B)
    signs = np.where(rng.random((B, L)) < 0.5, 1, -1).astype(np.int8)
    signs[np.arange(L)[None] >= depth[:, None]] = 0
    host["signs"] = signs
    host["nodes"] = np.where(signs != 0, rng.integers(0, n_aids - 1, (B, L)), 0)
    dup = B - len(np.unique(host["centers"]))
    overlap_share = float(np.isin(host["contexts"], host["negatives"]).mean())
    print(f"12a inputs: {B} pairs of the store's fasttext epoch ({dup} duplicated centers, "
          f"{100 * overlap_share:.1f}% of contexts also negatives), [{B} x {N}] negatives "
          f"({len(np.unique(host['negatives']))} distinct), 1,024 shared, tables {n_aids} x {D}",
          flush=True)
    base = [(rng.standard_normal((n_aids, D), dtype=np.float32) * 0.1) for _ in range(2)] + \
        [rng.uniform(0, 2, (n_aids, D)).astype(np.float32) for _ in range(2)]
    lr = float(np.float32(cfg.learning_rate))
    out = []
    for kind in ("per_pair", "weighted", "shared", "hs"):
        def run(state, d, kind=kind):
            t = {k: torch.as_tensor(v, device=d) for k, v in host.items()}
            if kind == "hs":
                return emb.hs_step(*state, t["centers"], t["nodes"], t["signs"], lr)
            if kind == "shared":
                return emb.sgns_shared_neg_step(*state, t["centers"], t["contexts"],
                                                t["weight"], t["shared"], lr, N)
            return emb.sgns_step(*state, t["centers"], t["contexts"], t["negatives"], lr,
                                 weight=t["weight"] if kind == "weighted" else None)

        def state_on(d, kind=kind):
            s = list(emb.sgns_state_from_jax(*base, device=d))
            if kind == "hs":  # the node table holds V - 1 rows
                s[1], s[3] = s[1][:-1].contiguous(), s[3][:-1].contiguous()
            return s

        results = {}
        for d in (torch.device("cpu"), dev):
            s = state_on(d)
            with emb.full_f32_matmul():
                loss = float(run(s, d))
            results[d.type] = (loss, s)
        (l_cpu, s_cpu), (l_dev, s_dev) = results["cpu"], results[dev.type]
        worst, err = 0.0, 0.0
        for a, b in zip(s_dev, s_cpu):
            diff = (a.cpu() - b).abs()
            worst = max(worst, float((diff / (b.abs() + STEP_FLOOR)).max()))
            err = max(err, float(diff.max()))
        check(worst <= STEP_RTOL, f"12a {kind} step: card vs CPU {worst:.3e} > {STEP_RTOL}")
        loss_rel = abs(l_dev - l_cpu) / abs(l_cpu)
        check(loss_rel <= LOSS_RTOL, f"12a {kind} step: loss {l_dev} vs CPU {l_cpu}")
        del s_cpu, results
        with emb.full_f32_matmul():
            ms = (cuda_ms(torch, lambda: run(s_dev, dev), reps) if dev.type == "cuda"
                  else _host_ms(lambda: run(s_dev, dev), 2))
        if kind == "hs":
            rows_out, width = host["nodes"].reshape(-1), L
        elif kind == "shared":
            rows_out, width = np.concatenate([host["contexts"], host["shared"]]), 1024
        else:
            rows_out, width = np.concatenate([host["contexts"], host["negatives"].ravel()]), N
        idx_bytes = sum(host[k].nbytes for k in (
            ("centers", "nodes", "signs") if kind == "hs" else
            ("centers", "contexts", "shared", "weight") if kind == "shared" else
            ("centers", "contexts", "negatives") + (("weight",) if kind == "weighted" else ())))
        n_out = len(rows_out) if kind != "shared" else B + 1024
        flops = 6.0 * B * width * D + 6.0 * D * (B + n_out)
        b = step_bound(host["centers"], rows_out, idx_bytes, D, flops)
        print(f"12a {kind} step [{B} pairs x {width} x {D}]: card vs CPU max "
              f"|diff|/(|cpu| + {STEP_FLOOR}) {worst:.3e} (limit {STEP_RTOL}), max abs {err:.3e}, "
              f"loss rel {loss_rel:.2e} (limit {LOSS_RTOL}); {ms:.4f} ms a step; bound "
              f"{b[0]:.4f} ms ({b[1]}): {100 * b[0] / ms:.1f}% of it", flush=True)
        out.append({"step": kind, "ms": ms, "bound_ms": b[0], "bound_by": b[1],
                    "max_rel_err": worst})
        del s_dev
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def trainer_line(name: str, out: dict) -> str:
    losses = out["losses"]
    return (f"{name}: {out['pairs_trained']} pairs, {out['steps']} steps in "
            f"{out['train_s']:.2f} s: {out['pairs_per_s']:.0f} pairs/s, "
            f"{1e3 * out['train_s'] / max(out['steps'], 1):.3f} ms a step; loss of the first "
            f"group {losses[0][2]:.4f}, of the last {losses[-1][2]:.4f}")


def sgns_trainers(torch, dev, store, n_aids: int) -> dict:
    """Phase 12b: ``train_sgns`` one epoch with fasttext (ns) and word2vec
    (hs), ``train_sgns_device`` one epoch with fasttext and 1,024 shared
    negatives; pairs, rates, ms a step, first and last group's loss (the
    last must be lower); the device sampler's kept pairs against the host
    epoch's pair count scaled to its draws, within KEPT_BAND."""
    from otto_tpu_torch.models.embeddings import train_sgns, train_sgns_device

    res = {}
    for name in ("fasttext", "word2vec"):
        cfg = sgns_config(name)
        out = {}
        model = train_sgns(store, n_aids, cfg, log_every=cfg.steps_per_call, pairs_out=out,
                           device=dev)
        sync(torch, dev)
        check(bool(torch.isfinite(model.w_in).all()), f"train_sgns {name}: non-finite table")
        losses = out["losses"]
        check(len(losses) >= 2 and losses[-1][2] < losses[0][2],
              f"train_sgns {name}: loss did not fall ({losses[0][2]} -> {losses[-1][2]})")
        print(trainer_line(f"12b train_sgns {name} ({cfg.objective})", out), flush=True)
        res[name] = {k: out[k] for k in ("pairs_trained", "steps", "train_s", "pairs_per_s")}
        res[name]["loss_first_last"] = [losses[0][2], losses[-1][2]]
        del model
    cfg = sgns_config("fasttext")
    out = {}
    model = train_sgns_device(store, n_aids, cfg, shared_negatives=1024, pairs_out=out,
                              device=dev)
    sync(torch, dev)
    check(bool(torch.isfinite(model.w_in).all()), "train_sgns_device: non-finite table")
    ep = out["epoch_log"][0]
    draws = ep["steps_run"] * cfg.batch_centers
    expected = res["fasttext"]["pairs_trained"] * draws / (2 * ep["kept_events"] * cfg.window)
    ratio = out["pairs_trained"] / expected
    print(f"12b train_sgns_device fasttext (1,024 shared negatives): {out['pairs_trained']} "
          f"pairs kept of {draws} draws in {ep['steps_run']} steps, {out['train_s']:.2f} s: "
          f"{out['pairs_per_s']:.0f} pairs/s, {1e3 * ep['step_s'] / ep['steps_run']:.3f} ms a "
          f"step; loss {ep['loss']:.4f}; kept / the host epoch's {res['fasttext']['pairs_trained']} "
          f"pairs scaled to the draws: {ratio:.5f} (band 1 +- {KEPT_BAND})", flush=True)
    check(abs(ratio - 1) <= KEPT_BAND, f"train_sgns_device kept {ratio} of the host's rate")
    res["device"] = {"pairs_trained": out["pairs_trained"], "train_s": out["train_s"],
                     "pairs_per_s": out["pairs_per_s"], "kept_ratio": ratio}
    del model
    return res


def planted_store(n_aids: int, clusters: int, per: int, sessions: int, length: int, seed: int):
    """Sessions confined to one cluster each: ``clusters`` x ``per`` aids
    drawn without replacement from [0, ``n_aids``), ``length`` events a
    session drawn from its cluster.  Returns the store and the clusters."""
    from otto_tpu_torch.data.events import EventStore

    rng = np.random.default_rng(seed)
    members = rng.choice(n_aids, clusters * per, replace=False).reshape(clusters, per)
    own = rng.integers(0, clusters, sessions)
    aid = members[own[:, None], rng.integers(0, per, (sessions, length))].ravel()
    store = EventStore.from_flat(np.repeat(np.arange(sessions), length), aid,
                                 np.tile(np.arange(length), sessions),
                                 np.zeros(sessions * length, np.int8))
    return store, members


def trained_table(torch, dev, target, n_aids: int, zero_counters, read_counters,
                  planted: dict = PLANTED, n_check: int = 256) -> dict:
    """Phase 12c: one fasttext epoch on the planted-cluster corpus, then
    ``neighbor_table(k=21)`` over the whole catalog (the fused route) and
    ``embedding_knn_predictions`` on phase 7's target with it, counters
    zeroed before and read after; the share of trained aids whose top
    neighbor is in their own cluster, and the table's rows against the
    exact scan on ``n_check`` trained aids."""
    from otto_tpu_torch.models.embeddings import embedding_knn_predictions, train_sgns
    from otto_tpu_torch.ops.retrieval import topk_scan

    store, members = planted_store(n_aids, seed=SEED + 13, **planted)
    t0 = time.perf_counter()
    model = train_sgns(store, n_aids, sgns_config("fasttext"), device=dev)
    sync(torch, dev)
    train_s = time.perf_counter() - t0
    zero_counters()
    t0 = time.perf_counter()
    table = model.neighbor_table(k=K_NNS)
    table_s = time.perf_counter() - t0
    preds = embedding_knn_predictions(target, table, device=dev)
    launches = read_counters("trained table's neighbor table and kNN serving",
                             ("fused_stage1", "peel_rows", "aid_vote"))
    cluster = np.full(n_aids, -1)
    cluster[members.ravel()] = np.repeat(np.arange(len(members)), members.shape[1])
    trained = members.ravel()
    same = float(np.mean(cluster[table[trained, 0]] == cluster[trained]))
    sample = np.random.default_rng(SEED + 14).choice(trained, n_check, replace=False)
    _, ei = topk_scan(model.w_in[torch.as_tensor(sample, device=dev)], model.w_in,
                      k=K_NNS + 1, metric="euclidean")
    ei = ei.cpu().numpy()
    rec = overlap(table[sample], np.stack([r[r != a][:K_NNS] for r, a in zip(ei, sample)]))
    p = preds["clicks"]
    check(p.shape == (target.n_sessions, 20) and p.max() < n_aids, "12c predictions shape")
    print(f"12c planted corpus ({planted['clusters']} clusters x {planted['per']} aids spread "
          f"over [0, {n_aids}), {store.n_events} events): fasttext epoch {train_s:.2f} s; "
          f"neighbor table k={K_NNS} over {n_aids} aids {table_s:.2f} s; trained aids whose top "
          f"neighbor is in their cluster {same:.4f} (limit {PLANTED_SAME_CLUSTER}); rows vs "
          f"exact scan on {n_check} trained aids {rec:.4f} (limit 0.99)", flush=True)
    check(same >= PLANTED_SAME_CLUSTER, f"12c same-cluster share {same}")
    check(rec >= 0.99, f"12c trained table recall {rec} < 0.99")
    return {"launches": launches, "same_cluster": same, "recall": rec, "table_s": table_s,
            "train_s": train_s}


def cli_sgns(torch, dev, store, workdir: Path, n_aids: int, zero_counters,
             read_counters) -> dict:
    """Phase 12d: ``embedding_knn validation`` and ``doc2vec validation`` on
    phase 10's store (phase 7's, as parquet) with a one-epoch copy of
    ``configs/fasttext.yaml``, then ``embedding_knn submission`` on it with
    its first 20,000 sessions as ``--test-events``: the file read back equal
    to the lists the runner returned in that call (a second training on the
    card would add in another order).  Counters zeroed before each run and
    read after it."""
    import yaml

    from otto_tpu_torch import pipelines
    from otto_tpu_torch.data.submission import read_submission
    from otto_tpu_torch.models import embeddings

    events, test, cfg, out = (workdir / "events.parquet", workdir / "test.parquet",
                              workdir / "fasttext_1epoch.yaml", workdir / "sub.csv.gz")
    store.to_parquet(events)
    head = head_sessions(store, 20_000)
    head.to_parquet(test)
    cfg.write_text(yaml.safe_dump(sgns_config("fasttext").to_dict()))
    common = ["--events", str(events), "--config", str(cfg), "--n-aids", str(n_aids),
              "--device", dev.type]
    res = {}
    spent = []

    def timed(real):  # the runner's SGNS training, drained
        def train(*args, **kwargs):
            t = time.perf_counter()
            model = real(*args, **kwargs)
            sync(torch, dev)
            spent.append(time.perf_counter() - t)
            return model
        return train

    for name, argv, expect in (
            ("embedding_knn validation", ["embedding_knn", "validation"],
             ("fused_stage1", "peel_rows", "aid_vote")),
            ("doc2vec validation", ["doc2vec", "validation"], ()),
            ("embedding_knn submission", ["embedding_knn", "submission", "--test-events",
                                          str(test), "--output", str(out)],
             ("fused_stage1", "peel_rows", "aid_vote"))):
        zero_counters()
        t0 = time.perf_counter()
        with wrapped(embeddings, "train_sgns", timed):
            r = pipelines.main(argv + common)
        sync(torch, dev)
        secs = time.perf_counter() - t0
        launches = read_counters(f"CLI {name}", expect)
        line = (f"weighted {r.report.weighted:.6f} (clicks {r.report.clicks:.6f}, carts "
                f"{r.report.carts:.6f}, orders {r.report.orders:.6f})" if r.report else
                f"{head.n_sessions} sessions written")
        print(f"12d CLI {name}: {secs:.2f} s, of it SGNS training {spent[-1]:.2f} s "
              f"({100 * spent[-1] / secs:.1f}%); {line}", flush=True)
        res[name] = {"s": secs, "train_s": spent[-1], "launches": launches,
                     "weighted": r.report.weighted if r.report else None}
        if r.report is not None:
            check(0 < r.report.weighted < 1, f"CLI {name}: weighted recall")
    lists = submission_lists(read_submission(out), head.session_ids)
    for t in TYPE_NAMES:
        check(np.array_equal(lists[t], r.predictions[t]),
              f"CLI embedding_knn submission: the {t} file differs from the runner's lists")
    print("12d the submission file equals the runner's lists", flush=True)
    return res


def two_stage_trains_sgns(torch, dev, bench_store, workdir: Path, n_aids: int, zero_counters,
                   read_counters) -> dict:
    """Phase 12e: ``run_two_stage(sgns_config=fasttext, 1 epoch)`` on phase
    11d's store cut to its first TWO_STAGE_SGNS_SESSIONS sessions (val 0.5, seed 0; 11d's
    20-tree, 3-fold bce rankers) over ``n_aids`` aids, enough for the SGNS
    table to take the fused route: the first run trains SGNS, saves ``sgns.npz``
    and the rankers (K1, K2, K5, K4 bin launch); the second resumes them
    (no SGNS training, no K5), and its lists equal ``predict_two_stage``
    with the saved artifacts (the first run's lists rank out-of-fold
    scores, so they differ, as in 11d)."""
    from otto_tpu_torch import twostage
    from otto_tpu_torch.config import GBDTConfig
    from otto_tpu_torch.data.splits import split_by_fraction

    sp = split_by_fraction(head_sessions(bench_store, TWO_STAGE_SGNS_SESSIONS), val_fraction=0.5,
                           seed=0)
    adir = workdir / "two_stage_sgns"
    kw = dict(labels=sp.val_labels, sgns_config=sgns_config("fasttext"),
              ranker_config=GBDTConfig(n_trees=20, n_folds=3, min_data_in_leaf=200,
                                       loss="bce"),
              artifact_dir=adir, device=dev)
    trained = []

    def counted(real):
        def train(*args, **kwargs):
            trained.append(1)
            return real(*args, **kwargs)
        return train

    res = {}
    with wrapped(twostage, "train_sgns", counted):
        for run, expect in (("first", ("fused_stage1", "peel_rows", "node_histograms",
                                       "bin_rows")),
                            ("resumed", ("fused_stage1", "peel_rows", "predict_forest_rows"))):
            zero_counters()
            stats = {}
            t0 = time.perf_counter()
            art = twostage.run_two_stage(sp.train, sp.val_input, n_aids, stats_out=stats, **kw)
            sync(torch, dev)
            secs = time.perf_counter() - t0
            launches = read_counters(f"run_two_stage with sgns_config, {run} run", expect)
            res[run] = {"s": secs, "sgns_s": stats["sgns_s"], "launches": launches,
                        "weighted": art.report.weighted, "trainings": len(trained)}
            print(f"12e run_two_stage(sgns_config) {run} run, {sp.val_input.n_sessions} target "
                  f"sessions: {secs:.2f} s, weighted {art.report.weighted:.6f}; SGNS "
                  f"trainings so far {len(trained)}; stages (s): "
                  + ", ".join(f"{k} {v:.2f}" for k, v in stats.items()), flush=True)
    check(res["first"]["trainings"] == 1 and (adir / "sgns.npz").exists(),
          "the first run did not train and save SGNS")
    check(res["resumed"]["trainings"] == 1 and res["resumed"]["launches"]["node_histograms"] == 0,
          "the resumed run trained SGNS or a ranker")
    want = twostage.predict_two_stage(twostage.TwoStageArtifacts.load(adir, device=dev),
                                      sp.train, sp.val_input, n_aids, device=dev)
    for t in TYPE_NAMES:
        check(np.array_equal(art.predictions[t], want[t]),
              f"12e resumed {t} lists differ from predict_two_stage's")
    print("12e the resumed lists equal predict_two_stage with the saved artifacts", flush=True)
    return res


# ------------------------------------------------------------- phase 13
# The listwise tower at its published widths (configs/ranker.yaml: (256,
# 256, 128), lambdarank, 5 folds, 5 epochs, 512 sessions a step; dropout 0.1,
# RankerConfig's default, since the file sets none) over the two-stage
# path's 55 features (RANKER_FEATURES and heuristic_rank_score).
TOWER_CONFIG = REPO / "configs" / "ranker.yaml"
# 13a: the forward card against the CPU (the limits of
# tests/test_torch_ranker.py), one step's loss in float32 and bfloat16
# compute, and the reference bench's scoring shape (bench.py:360-362,
# 509-518: one tower over [1,024 x 128 x 52]).
TOWER_SHARE, TOWER_REL, TOWER_FLOOR, TOWER_WORST = 0.99, 1e-5, 1e-3, 4e-3
STEP_LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-4}
BENCH_TOWER = (1024, 128, 52)
TOWER_SESSIONS = 10_000  # 13b-13c (20,000 until 3b's deep route came)
TOWER_CUTS = ("13b-13c: phase 11d's store cut to its first 10,000 sessions (5,000 target, "
              "val 0.5, seed 0; 20,000 until 3b's deep route came, when the script took "
              "1,210.5 s of phases "
              "on a slow host) over the bench's 20,000 aids; the tower/GBDT pair and the "
              "streamed run on its first 5,000 (2,500 target), the pair's tower cut to 1 "
              "epoch and its GBDT to 10 trees, 2 folds; the streamed run trains on 1,250 of "
              "the 2,500 target sessions and streams the other 1,250",
              "13d: phase 7's store (200,000 sessions over 1,855,603 aids, 2,599,069 "
              "events; the OTTO week has ~220M events) as .jsonl; card vs CPU on the first "
              "2,000 target sessions")


def tower_flops(n_features: int, hidden) -> int:
    """Multiply-adds times two of one candidate through the tower."""
    dims = [n_features, *hidden, 1]
    return 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def seeded_tower(torch, n_features: int, hidden, seed: int):
    """Tower parameters from ``init_tower`` (a seeded generator) with
    nonzero biases, so every layer's sum is exercised."""
    from otto_tpu_torch.models import ranker

    params = ranker.init_tower(n_features, hidden, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    for k in params:
        if k.startswith("b"):
            params[k] = torch.from_numpy((rng.normal(size=params[k].shape) * 0.1)
                                         .astype(np.float32))
    return params


def tower_full_width(torch, dev, n_sessions: int = 4096, n_check: int = 512,
                     width: int = 184, bench_shape=BENCH_TOWER) -> dict:
    """Phase 13a: the forward at [4,096 x 184 x 55] on the card, its first
    512 sessions against the CPU (99% of scores within 1e-5 * (|s| + 1e-3),
    every one within 4e-3 * max |s|); one lambdarank step at [512 x 184 x
    55] in float32 and in bfloat16 compute, card against CPU (the loss
    within 1e-5 and 1e-4 relative); ms a step on the card (bfloat16,
    dropout on, as training runs it); candidates scored per second at the
    reference bench's [1,024 x 128 x 52] (``bench_shape``) against the
    bound of the route the products take."""
    from otto_tpu_torch.config import RankerConfig
    from otto_tpu_torch.features import RANKER_FEATURES
    from otto_tpu_torch.models import ranker
    from otto_tpu_torch.utils.runtime import full_f32_matmul

    cfg = RankerConfig.from_yaml(TOWER_CONFIG)
    F = len(RANKER_FEATURES) + 1
    rng = np.random.default_rng(SEED + 13)
    params = seeded_tower(torch, F, cfg.hidden_dims, SEED)
    x = torch.from_numpy((rng.normal(size=(n_sessions, width, F)) * 3).astype(np.float32))
    card, cpu = ranker.Tower(params).to(dev), ranker.Tower(params)
    with torch.no_grad(), full_f32_matmul():
        got = card(x.to(dev)).cpu().numpy()
        t0 = time.perf_counter()
        want = cpu(x[:n_check]).numpy()
        cpu_s = time.perf_counter() - t0
    check(got.shape == (n_sessions, width) and np.isfinite(got).all(),
          "tower forward: bad scores")
    d = np.abs(got[:n_check] - want)
    share = float((d <= TOWER_REL * (np.abs(want) + TOWER_FLOOR)).mean())
    worst = float(d.max() / np.abs(want).max())
    print(f"13a tower forward [{n_sessions} x {width} x {F}] on the card; its first "
          f"{n_check} sessions vs the "
          f"CPU ({cpu_s:.2f} s): {100 * share:.3f}% within {TOWER_REL} * (|s| + {TOWER_FLOOR}), "
          f"largest difference {worst:.3e} of max |s| {np.abs(want).max():.3f}", flush=True)
    check(share >= TOWER_SHARE and worst <= TOWER_WORST,
          f"tower forward card vs CPU: {share} within, worst {worst}")

    B = min(cfg.batch_sessions, n_sessions)
    y = torch.from_numpy((rng.random((B, width)) < 0.1).astype(np.int8))
    m = torch.from_numpy(rng.random((B, width)) < 0.9)
    step = {}
    for compute in ("float32", "bfloat16"):
        losses, trained = [], []
        for d_ in (dev, torch.device("cpu")):
            tower = ranker.Tower(params).to(d_)
            losses.append(float(ranker.train_step(
                tower, ranker.make_optimizer(tower, cfg), x[:B].to(d_), y.to(d_), m.to(d_),
                ranker.learning_rate(cfg, 0), loss=cfg.loss,
                compute_dtype=getattr(torch, compute))))
            trained.append(ranker.tower_params_to_numpy(tower))
        rel = abs(losses[0] - losses[1]) / abs(losses[1])
        moved = max(float(np.abs(trained[0][k] - trained[1][k]).max()) for k in trained[0])
        step[compute] = {"loss_card": losses[0], "loss_cpu": losses[1], "rel": rel,
                         "param_max_diff": moved}
        print(f"13a one {cfg.loss} step [{B} x {width} x {F}], {compute} compute: loss card "
              f"{losses[0]:.9g} cpu {losses[1]:.9g} (relative {rel:.2e}); largest parameter "
              f"difference {moved:.3e} (lr {cfg.learning_rate})", flush=True)
        check(rel <= STEP_LOSS_RTOL[compute], f"tower step ({compute}): loss relative {rel}")

    tower = ranker.Tower(params).to(dev)
    opt = ranker.make_optimizer(tower, cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xb, yb, mb = x[:B].to(dev), y.to(dev), m.to(dev)
    step_ms = cuda_ms(torch, lambda: ranker.train_step(
        tower, opt, xb, yb, mb, ranker.learning_rate(cfg, 0), loss=cfg.loss,
        dropout=cfg.dropout, generator=gen), reps=20, warmup=3)
    print(f"13a a training step on the card (bfloat16 compute, dropout {cfg.dropout}): "
          f"{step_ms:.3f} ms", flush=True)

    B, C, Fb = bench_shape
    bench = ranker.Tower(seeded_tower(torch, Fb, cfg.hidden_dims, SEED + 1)).to(dev)
    xb = torch.randn((B, C, Fb), generator=torch.Generator(device=dev).manual_seed(SEED),
                     device=dev)

    def score():
        with torch.no_grad(), full_f32_matmul():
            return bench(xb)

    ms = cuda_ms(torch, score, reps=20, warmup=3)
    flops = tower_flops(Fb, cfg.hidden_dims) * B * C
    b_ms, b_by = bound(xb.numel() * 4 + B * C * 4, flops, F32_OPS_PER_S)
    rate = B * C / (ms / 1e3)
    print(f"13a candidates scored per second at [{B} x {C} x {Fb}] (one tower, bfloat16 "
          f"operands, route: float32 products of the rounded values with TF32 off, at the "
          f"float32 peak of {F32_OPS_PER_S / 1e12:.0f} TFLOP/s): {ms:.4f} ms a call, "
          f"{rate:.4g} candidates/s; bound {b_ms:.4f} ms ({b_by}: {flops / 1e9:.2f} GFLOP), "
          f"{100 * b_ms / ms:.1f}% of it", flush=True)
    return {"forward_share": share, "forward_worst": worst, "step": step, "step_ms": step_ms,
            "bench_ms": ms, "candidates_per_s": rate, "bound_ms": b_ms, "bound_by": b_by}


def artifact_differences(a: Path, b: Path) -> list[str]:
    """Where two artifact directories' predictions, meta and ranker arrays
    differ (empty when they are equal)."""
    names = sorted(p.name for p in a.glob("ranker_*.npz"))
    if names != sorted(p.name for p in b.glob("ranker_*.npz")):
        return [f"rankers {names}"]
    out = []
    if json.loads((a / "meta.json").read_text()) != json.loads((b / "meta.json").read_text()):
        out.append("meta.json")
    for name in ["predictions.npz", *names]:
        with np.load(a / name, allow_pickle=True) as x, np.load(b / name, allow_pickle=True) as y:
            for k in sorted(set(x.files) | set(y.files)):
                if k not in x.files or k not in y.files:
                    out.append(f"{name}:{k} missing")
                elif not np.array_equal(x[k], y[k], equal_nan=x[k].dtype.kind == "f"):
                    diff = (float(np.abs(x[k] - y[k]).max()) if x[k].dtype.kind == "f"
                            and x[k].shape == y[k].shape else None)
                    out.append(f"{name}:{k} (max abs diff {diff})")
    return out


def tower_training(torch, dev, bench_store, workdir: Path, zero_counters, read_counters,
                   n_sessions: int = TOWER_SESSIONS) -> dict:
    """Phase 13b: ``run_two_stage(ranker_config=<configs/ranker.yaml>)`` on
    phase 11d's store cut to its first ``n_sessions`` sessions (val 0.5, seed 0)
    into an empty artifact directory: ``train_s``, the steps and ms a step,
    each fold's loss falling from its first epoch to its last, MAP@20 per
    fold, ``report`` and ``report_disjoint`` and the paired bootstrap of
    the lift over the heuristic on the disjoint half (1,000 draws; its ci95
    upper end above 0).  Then the same call resumes (no step) and its lists
    equal ``predict_two_stage`` with the saved artifacts; the tower paired
    with a small GBDT (``second_ranker_config``) launches K5, K4 and K4 bin,
    and ``run_two_stage_streamed`` trains a tower on half the target
    sessions and streams the other half, both on the store's first
    ``n_sessions // 2`` sessions.  Returns the runs' numbers and
    launches."""
    from otto_tpu_torch import streaming, twostage
    from otto_tpu_torch.config import GBDTConfig, RankerConfig
    from otto_tpu_torch.data.splits import split_by_fraction
    from otto_tpu_torch.eval.harness import paired_bootstrap_lift
    from otto_tpu_torch.models import ranker

    cfg = RankerConfig.from_yaml(TOWER_CONFIG)
    sp = split_by_fraction(head_sessions(bench_store, n_sessions), val_fraction=0.5, seed=0)
    adir = workdir / "tower"
    log = {"steps": 0, "maps": [], "heur": []}

    def count_steps(real):
        def step(*args, **kwargs):
            log["steps"] += 1
            return real(*args, **kwargs)
        return step

    def keep_maps(real):
        def fold_map(*args, **kwargs):
            log["maps"].append(float(real(*args, **kwargs)))
            return torch.tensor(log["maps"][-1])
        return fold_map

    def keep_heur(real):
        def lists(*args):
            log["heur"].append(real(*args))
            return log["heur"][-1]
        return lists

    kw = dict(labels=sp.val_labels, ranker_config=cfg, artifact_dir=adir, device=dev)
    res = {}
    with wrapped(ranker, "train_step", count_steps), wrapped(ranker, "map_at_k", keep_maps), \
            wrapped(twostage, "_heuristic_lists", keep_heur):
        for run in ("trained", "resumed"):
            zero_counters()
            stats, steps0 = {}, log["steps"]
            t0 = time.perf_counter()
            art = twostage.run_two_stage(sp.train, sp.val_input, 20_000, stats_out=stats, **kw)
            sync(torch, dev)
            secs = time.perf_counter() - t0
            launches = read_counters(f"run_two_stage with the tower, {run}", ())
            res[run] = {"s": secs, "stats": stats, "steps": log["steps"] - steps0,
                        "art": art, "launches": launches}
            print(f"13b run_two_stage(tower) {run}, {sp.val_input.n_sessions} target sessions: "
                  f"{secs:.2f} s, {res[run]['steps']} steps; weighted "
                  f"{art.report.weighted:.6f}, disjoint {art.report_disjoint.weighted:.6f}; "
                  f"stages (s): " + ", ".join(f"{k} {v:.2f}" for k, v in stats.items()),
                  flush=True)
            if run == "trained":
                shutil.copytree(adir, workdir / "tower_trained")
    trained, resumed = res["trained"], res["resumed"]
    check(resumed["steps"] == 0, "the resumed run trained a tower")
    art = trained["art"]
    train_s, steps = trained["stats"]["train_s"], trained["steps"]
    print(f"13b tower training: train_s {train_s:.2f} s for {steps} steps "
          f"({1e3 * train_s / steps:.2f} ms a step, fold setup and OOF included)", flush=True)
    losses = {t: art.rankers[t].epoch_losses for t in TYPE_NAMES}
    for t in TYPE_NAMES:
        print(f"13b {t}: per-fold epoch losses "
              + "; ".join(", ".join(f"{v:.4f}" for v in e) for e in losses[t])
              + f"; alpha {art.rankers[t].prior_alpha}", flush=True)
        check(all(e[-1] < e[0] for e in losses[t]), f"13b {t}: a fold's loss did not fall")
    maps = log["maps"]
    check(len(maps) == 3 * cfg.n_folds, f"13b: {len(maps)} fold MAP@20 values")
    print("13b MAP@20 per fold: " + "; ".join(
        f"{t} " + ", ".join(f"{v:.4f}" for v in maps[i * cfg.n_folds:(i + 1) * cfg.n_folds])
        for i, t in enumerate(TYPE_NAMES)), flush=True)
    holdout = np.flatnonzero(~art.selection_mask)
    heur = log["heur"][0]
    boot = paired_bootstrap_lift(sp.val_labels.take(holdout),
                                 {t: art.predictions[t][holdout] for t in TYPE_NAMES},
                                 {t: heur[t][holdout, :20] for t in TYPE_NAMES}, n_boot=1000,
                                 seed=17)
    print(f"13b report {report_fields(art.report)}; report_disjoint ({len(holdout)} sessions) "
          f"{report_fields(art.report_disjoint)}; lift over the heuristic on the disjoint half "
          f"{boot['lift']:+.6f} ci95 {boot['ci95']} p<=0 {boot['p_le_0']:.4f}", flush=True)
    check(boot["ci95"][1] > 0, f"13b: the disjoint lift's ci95 {boot['ci95']} is not above 0")
    want = twostage.predict_two_stage(twostage.TwoStageArtifacts.load(adir, cfg, device=dev),
                                      sp.train, sp.val_input, 20_000, device=dev)
    for t in TYPE_NAMES:
        check(np.array_equal(resumed["art"].predictions[t], want[t]),
              f"13b resumed {t} lists differ from predict_two_stage's")
    differ = {t: int((art.predictions[t] != want[t]).any(axis=1).sum()) for t in TYPE_NAMES}
    print(f"13b the resumed lists equal predict_two_stage with the saved artifacts; sessions "
          f"whose lists differ between the training run (out-of-fold scores) and the resumed "
          f"one (fold average): {differ}", flush=True)

    half = split_by_fraction(head_sessions(bench_store, n_sessions // 2), val_fraction=0.5,
                             seed=0)
    pair_cfg = GBDTConfig(n_trees=10, n_folds=2, min_data_in_leaf=200, loss="bce")
    zero_counters()
    t0 = time.perf_counter()
    pair = twostage.run_two_stage(half.train, half.val_input, 20_000, labels=half.val_labels,
                                  ranker_config=cfg.replace(epochs=1),
                                  second_ranker_config=pair_cfg, device=dev)
    sync(torch, dev)
    pair_s = time.perf_counter() - t0
    pair_launches = read_counters("run_two_stage, a tower and a GBDT paired",
                                  ("node_histograms", "predict_forest", "bin_rows"))
    check(sorted(type(m).__name__ for m in pair.rankers.values())
          == ["GBDTRankerModel"] * 3 + ["RankerModel"] * 3, "13b: the pair's engines")
    print(f"13b a tower (1 epoch) paired with a GBDT ({pair_cfg.n_trees} trees, "
          f"{pair_cfg.n_folds} folds), {half.val_input.n_sessions} target sessions: "
          f"{pair_s:.2f} s, weighted {pair.report.weighted:.6f}", flush=True)

    stream_train = half.val_input.n_sessions // 2
    zero_counters()
    t0 = time.perf_counter()
    streamed = streaming.run_two_stage_streamed(
        half.train, half.val_input, 20_000, labels=half.val_labels, ranker_config=cfg,
        train_sessions=stream_train, n_boot=1000, device=dev)
    sync(torch, dev)
    streamed_s = time.perf_counter() - t0
    streamed_launches = read_counters("run_two_stage_streamed with the tower", ())
    b = streamed.bootstrap_vs_heuristic
    check(all(type(m).__name__ == "RankerModel" for m in streamed.artifacts.rankers.values())
          and streamed.timings["streamed_sessions"] == half.val_input.n_sessions - stream_train,
          "13b: the streamed run did not train towers and stream the rest")
    print(f"13b run_two_stage_streamed(tower), {stream_train} trained and "
          f"{streamed.timings['streamed_sessions']} streamed: {streamed_s:.2f} s (train "
          f"{streamed.timings['train_s']} s, stream {streamed.timings['stream_s']} s); "
          f"weighted {streamed.report.weighted:.6f}, lift {b['lift']:+.6f} ci95 {b['ci95']}",
          flush=True)
    return {"trained_s": trained["s"], "resumed_s": resumed["s"], "train_s": train_s,
            "steps": steps, "ms_a_step": 1e3 * train_s / steps, "maps": maps,
            "weighted": art.report.weighted, "weighted_disjoint": art.report_disjoint.weighted,
            "lift": boot, "pair_s": pair_s, "streamed_s": streamed_s,
            "streamed_lift": b, "launches": {"trained": trained["launches"],
                                             "resumed": resumed["launches"],
                                             "pair": pair_launches,
                                             "streamed": streamed_launches},
            "trained_report": art.report, "resumed_report": resumed["art"].report,
            "trained_lists": art.predictions, "resumed_lists": resumed["art"].predictions}


def tower_cli(torch, dev, bench_store, workdir: Path, trained: dict,
              n_sessions: int = TOWER_SESSIONS) -> dict:
    """Phase 13c: ``python -m otto_tpu_torch.pipelines two_stage validation``
    with no ``--ranker`` and no ``--config`` (the tower, ``RankerConfig()``,
    whose values are configs/ranker.yaml's) on 13b's ``n_sessions`` sessions as
    parquet (``--val-fraction 0.5 --seed 0``), into an empty directory, in
    this process: it trains, and its report, lists and files equal 13b's
    training run; the same command again resumes, and equals 13b's resumed
    run."""
    from otto_tpu_torch import pipelines

    events, cli_dir = workdir / "bench_head.parquet", workdir / "cli"
    head_sessions(bench_store, n_sessions).to_parquet(events)
    argv = ["two_stage", "validation", "--n-aids", "20000", "--val-fraction", "0.5",
            "--seed", "0", "--artifact-dir", str(cli_dir), "--events", str(events),
            "--device", dev.type]
    out = {}
    for run, want_dir in (("trained", workdir / "tower_trained"), ("resumed", workdir / "tower")):
        t0 = time.perf_counter()
        res = pipelines.main(argv)
        sync(torch, dev)
        out[run] = time.perf_counter() - t0
        same = (res.report == trained[f"{run}_report"]
                and all(np.array_equal(res.predictions[t], trained[f"{run}_lists"][t])
                        for t in TYPE_NAMES))
        check(same, f"13c the CLI's {run} run differs from 13b's in-memory call")
        differ = artifact_differences(cli_dir, want_dir)
        check(not differ, f"13c the CLI's {run} files differ from 13b's: {differ}")
        print(f"13c CLI two_stage validation (default --ranker tower), {run}: {out[run]:.2f} s, "
              f"weighted {res.report.weighted:.6f}; report, lists and files equal 13b's",
              flush=True)
    return out


def tfidf_run(torch, dev, store, workdir: Path, n_check: int = 2_000) -> dict:
    """Phase 13d: ``tfidf validation`` on phase 7's store as ``.jsonl``
    (the CLI in this process, ``--device cuda``): seconds and weighted
    recall.  Then on the first 2,000 target sessions the recommender on the
    card and on the CPU: the lists equal, or, where they differ, each
    differing session's similar-session sets differ only in near-ties of the
    float32 scan (float64 scores within 1e-5), counted."""
    from otto_tpu_torch import pipelines
    from otto_tpu_torch.config import DataConfig
    from otto_tpu_torch.data.ingest import read_jsonl
    from otto_tpu_torch.data.splits import split_by_fraction
    from otto_tpu_torch.models.tfidf import TfIdfModel, session_vectors
    from otto_tpu_torch.ops.retrieval import topk_scan

    jsonl = workdir / "events.jsonl"
    t0 = time.perf_counter()
    write_jsonl(store, jsonl)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = pipelines.main(["tfidf", "validation", "--events", str(jsonl), "--device", dev.type])
    sync(torch, dev)
    cli_s = time.perf_counter() - t0
    print(f"13d CLI tfidf validation on the .jsonl ({store.n_sessions} sessions, written in "
          f"{write_s:.2f} s): {cli_s:.2f} s, weighted {res.report.weighted:.6f} "
          f"{report_fields(res.report)}", flush=True)
    check(0 < res.report.weighted < 1, "13d: tfidf's weighted recall")
    sp = split_by_fraction(read_jsonl(jsonl), val_fraction=0.1, seed=42)
    model = TfIdfModel.fit(sp.train, DataConfig().n_aids)  # the CLI's --n-aids default
    target = head_sessions(sp.val_input, n_check)
    lists = [model.similar_session_predictions(target, device=d)["clicks"]
             for d in (dev, "cpu")]
    qv = session_vectors(target, model.n_aids, model.vectors.shape[1])
    sims = [topk_scan(torch.as_tensor(qv, device=d), torch.as_tensor(model.vectors, device=d),
                      k=5, block=16384, metric="dot")[1].cpu().numpy() for d in (dev, "cpu")]
    rows = np.flatnonzero((lists[0] != lists[1]).any(axis=1))
    for r in rows:
        # the j-th most similar session of each scan: a near-tie when their
        # float64 scores agree to 1e-5 at every position
        exact = model.vectors[np.concatenate([sims[0][r], sims[1][r]])].astype(np.float64) \
            @ qv[r].astype(np.float64)
        check(np.abs(exact[:5] - exact[5:]).max() <= 1e-5,
              f"13d session {r}: card and CPU scans differ beyond near-ties: "
              f"{sims[0][r].tolist()} vs {sims[1][r].tolist()}, scores {exact.tolist()}")
    near = len(rows)
    print(f"13d tfidf on {target.n_sessions} target sessions, card vs CPU: "
          f"{target.n_sessions - len(rows)} lists equal, {near} differ at near-ties of the "
          f"float32 scan", flush=True)
    return {"cli_s": cli_s, "weighted": res.report.weighted, "near_ties": near}


# ------------------------------------------------------------- phase 14
# The sequence recommenders with their published configs
# (configs/sequence_{gru,gru4rec_plus,narm,stamp,caser,transformer,moe}.yaml:
# dim 64, hidden 128, max_len 20, batch 2,048, 512 negatives, lr 1e-3, 3
# epochs; the transformers 2 layers of 2 heads, the MoE's FFNs 4 experts)
# over the full catalog.
SEQ_CONFIGS = ("gru", "gru4rec_plus", "narm", "stamp", "caser", "transformer", "moe")
SEQ_STORE_SESSIONS = 50_000  # 14b-14d: phase 7's store cut (100,000 until phase 3c, 200,000 before)
SEQ_CUTS = ("14b-14d: epochs 3 -> 1 for every config (a copy of each YAML with epochs: 1); "
            "phase 7's store (200,000 sessions over 1,855,603 aids, 2,599,069 events; the "
            f"OTTO week has ~220M events) cut to its first {SEQ_STORE_SESSIONS:,} sessions "
            "(the whole store until 3b's deep route came, when the script took 1,210.5 s "
            "of phases on a slow host; 100,000 until phase 3c came, when it took 1,088.89 s "
            "of phases on a slow host): run_sequence trains gru on the split's training "
            "sessions (90%) and serves its target sessions (10%)",
            "14b: the six other configs train on the split's first 10,000 training sessions "
            "(phase 14 ran past 200 s uncut, and at 90,000 the script past 850 s; 45,000 until "
            "phase 16 came, when the script's phases 1-15 took 955 s on one host; 25,000 "
            "until phase 17 came, when the script took 1,070.58 s of phases on one host; "
            "15,000 until phase 18 came) and serve the same target sessions",
            "14d: the subprocess's sequence submission on phase 7's first 10,000 sessions",
            "14a: card against CPU on one step from one seeded batch of phase 7's examples "
            "and on 512 of its sessions")
SEQ_CUT_TRAIN_SESSIONS = 10_000  # 14b: the non-default configs' training sessions
# phase 3c's cost (7.5-7.8 s of phases on an H100) is paid by phase 14's store
PHASE3C_CUTS = (f"14b-14d: phase 7's store 100,000 -> {SEQ_STORE_SESSIONS:,} sessions (14b's "
                "and 14d's gru runs took 26.5 s each at 100,000 on a slow host)",)
SEQ_SUBMISSION_SESSIONS = 10_000  # 14d: the subprocess's store (20,000 until phase 18)
# 14a: session vectors within SEQ_ENC_RTOL * (|x| + SEQ_ENC_FLOOR * max |x|),
# max over the batch (cuBLAS and the CPU sum each float32 dot in another
# order, and the GRU carries the difference through 20 steps: some 1e-7 of
# the vectors' O(1) scale, which at an entry near 0 is far more than 1e-5 of
# the entry itself; the share within 1e-5 * (|x| + 1e-3) is printed); one
# step's loss within SEQ_LOSS_RTOL relative, every updated parameter within
# SEQ_STEP_RTOL * (|x| + SEQ_STEP_FLOOR) but where the CPU's gradient is at
# most SEQ_TINY_GRAD of its leaf's largest (Adam's first step moves an entry
# by about +-lr whatever |g|, so a gradient at its rounding error's level
# decides the sign; those within 2 lr, counted, at most 1e-5 of the entries).
SEQ_ENC_RTOL, SEQ_ENC_FLOOR = 1e-5, 0.1
SEQ_LOSS_RTOL = 1e-5
SEQ_STEP_RTOL, SEQ_STEP_FLOOR, SEQ_TINY_GRAD = 1e-4, 0.01, 1e-4
SEQ_RECALL = 0.99  # 14c: full_sort_topk against the exact scan


def seq_config_path(name: str) -> Path:
    return REPO / "configs" / f"sequence_{name}.yaml"


def seq_cut_yaml(name: str, workdir: Path) -> Path:
    """A copy of the published YAML with ``epochs: 1`` (SEQ_CUTS)."""
    import yaml

    d = yaml.safe_load(seq_config_path(name).read_text())
    d["epochs"] = 1
    path = workdir / f"sequence_{name}_1epoch.yaml"
    path.write_text(yaml.safe_dump(d))
    return path


def seq_step_bound(params) -> tuple[float, str]:
    """A training step's bound: the dense Adam's bytes, every parameter, its
    gradient and both moments read and the parameter and moments written,
    4 bytes each, at the memory rate."""
    from otto_tpu_torch.models import sequence as sq

    n = sum(t.numel() for t in sq.tree_leaves(params))
    return bound(7 * 4 * n, 0.0, F32_OPS_PER_S)


def seq_step_matches(torch, cpu, card, lr: float, what: str = "14a") -> int:
    """Phase 14a's hold of the card's updated parameters on the CPU's
    (SEQ_STEP_*, SEQ_TINY_GRAD); ``cpu`` carries its gradients (the
    reference: on the CPU in 14a, on the card in 17b and 18, where the
    compare runs on the card).  Returns the count of entries whose sign a
    rounding-level gradient decided."""
    from otto_tpu_torch.models import sequence as sq

    flipped, total = 0, 0
    for c, g in zip(sq.tree_leaves(cpu), sq.tree_leaves(card)):
        d = (g.detach().to(c.device) - c.detach()).abs()
        off = d > SEQ_STEP_RTOL * (c.detach().abs() + SEQ_STEP_FLOOR)
        tiny = c.grad.abs() <= SEQ_TINY_GRAD * c.grad.abs().max()
        check(not bool((off & ~tiny).any()), f"{what}: an updated parameter of shape "
              f"{tuple(c.shape)} differs beyond {SEQ_STEP_RTOL} * (|x| + {SEQ_STEP_FLOOR})")
        check(bool((d[off] <= 2 * lr).all()), f"{what}: a sign-decided entry moved beyond 2 lr")
        flipped += int(off.sum())
        total += c.numel()
    check(flipped <= 1e-5 * total, f"{what}: {flipped} of {total} entries sign-decided")
    return flipped


def seq_card_vs_cpu(torch, dev, store, n_aids: int, n_enc: int = 512, reps: int = 10) -> dict:
    """Phase 14a: for each published config at its widths over ``n_aids``,
    the session vectors of ``store``'s first ``n_enc`` sessions and one
    training step (the first batch and negatives a seed-``config.seed``
    trainer would draw from ``store``'s examples) on the card and the CPU
    from the same parameters; then ms a step on the card (CUDA events over
    ``reps`` steps on that batch) against the dense Adam's bound."""
    from otto_tpu_torch.models import sequence as sq

    enc_store = head_sessions(store, n_enc)
    out = {}
    examples = None
    for name in SEQ_CONFIGS:
        cfg = sq.SequenceModelConfig.from_yaml(seq_config_path(name)).replace(n_aids=n_aids)
        if examples is None or examples[0].shape[1] != cfg.max_len:
            examples = sq._training_examples(store, cfg.max_len, n_aids)
        seqs, masks, targets = examples
        rng = np.random.default_rng(cfg.seed)
        sel = rng.permutation(len(targets))[:cfg.batch_size]
        negs = rng.integers(0, n_aids, (cfg.batch_size, cfg.n_negatives)).astype(np.int32)
        batch = (seqs[sel], masks[sel], targets[sel], negs)
        base = sq._config_params(cfg, torch.Generator().manual_seed(cfg.seed))
        runs = []
        for d in ("cpu", dev):
            p = sq._tree_map(lambda t: t.to(d, copy=True), base)
            vec = sq.SequenceModel(p, cfg).session_vectors(enc_store).cpu()
            p = sq._tree_map(lambda t: t.requires_grad_(True), p)
            opt = sq.make_optimizer(p, cfg)
            xb = tuple(torch.as_tensor(a, device=d) for a in batch)
            loss = float(sq.train_step(p, opt, *xb, loss=cfg.loss, bpr_reg=cfg.bpr_reg))
            runs.append((vec, loss, p, opt, xb))
        del base
        (cv, cl, cp, _, _), (gv, gl, gp, gopt, gxb) = runs
        dv = (gv - cv).abs()
        scale = float(cv.abs().max())
        enc_err = float((dv / (cv.abs() + SEQ_ENC_FLOOR * scale)).max())
        enc_share = float((dv <= 1e-5 * (cv.abs() + 1e-3)).float().mean())
        check(enc_err <= SEQ_ENC_RTOL, f"14a {name}: session vectors, card vs CPU, {enc_err}")
        check(abs(gl - cl) <= SEQ_LOSS_RTOL * abs(cl), f"14a {name}: loss {gl} vs CPU {cl}")
        flipped = seq_step_matches(torch, cp, gp, cfg.learning_rate)
        del runs, cp
        if dev.type == "cuda":
            ms = cuda_ms(torch, lambda: sq.train_step(gp, gopt, *gxb, loss=cfg.loss,
                                                      bpr_reg=cfg.bpr_reg), reps)
        else:
            ms = _host_ms(lambda: sq.train_step(gp, gopt, *gxb, loss=cfg.loss,
                                                bpr_reg=cfg.bpr_reg), 1)
        b = seq_step_bound(gp)
        out[name] = {"enc_rel_err": enc_err, "enc_max_abs_err": float(dv.max()),
                     "enc_max_abs": scale, "enc_share_1e5": enc_share, "loss": gl, "loss_cpu": cl, "sign_decided": flipped,
                     "step_ms": ms, "bound_ms": b[0]}
        print(f"14a {name}: session vectors card vs CPU max abs err {float(dv.max()):.3e} "
              f"(max |x| {scale:.3f}), max {enc_err:.3e} of (|x| + {SEQ_ENC_FLOOR} max |x|) "
              f"(limit {SEQ_ENC_RTOL}), {100 * enc_share:.3f}% within 1e-5 * (|x| + 1e-3); "
              f"one step's loss {gl:.7f} card, "
              f"{cl:.7f} CPU; updated parameters within the limits, {flipped} entries "
              f"sign-decided by rounding-level gradients; {ms:.3f} ms a step at "
              f"[{cfg.batch_size} x {cfg.max_len}], {cfg.n_negatives} negatives (CUDA events); "
              f"bound {b[0]:.3f} ms ({b[1]}: the dense Adam over "
              f"{sum(t.numel() for t in sq.tree_leaves(gp)):,} parameters), "
              f"{100 * b[0] / ms:.1f}% of it", flush=True)
        del gp, gopt, gxb
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def seq_draw_ms(n_aids: int, B: int, n_neg: int, reps: int = 20) -> float:
    """Host ms of one step's negative draw, as the trainer makes it."""
    rng = np.random.default_rng(0)
    return _host_ms(lambda: rng.integers(0, n_aids, (B, n_neg)).astype(np.int32), reps)


def seq_runs(torch, dev, split, workdir: Path, zero_counters, read_counters) -> dict:
    """Phase 14b: ``run_sequence`` with each published config (epochs cut to
    1) on ``split`` (that of phase 7's store cut to SEQ_STORE_SESSIONS),
    counters zeroed before each run and read after
    (K1, K2 and K3 must launch): ``train_s``, steps, ms a step and the
    negative draw's host share, the mean loss of the last tenth of the steps
    against the first tenth (it must fall), the routes, serve seconds,
    sessions/s, weighted recall@20.  gru, the default, trains on the whole
    split; the others on its first SEQ_CUT_TRAIN_SESSIONS training sessions
    (SEQ_CUTS).  Returns each run's numbers, lists, report and model (the
    model of gru alone)."""
    from otto_tpu_torch import pipelines
    from otto_tpu_torch.models import sequence as sq
    from otto_tpu_torch.models.covisitation import session_unique_counts

    target = split.val_input
    counts = session_unique_counts(target)
    out = {}
    for name in SEQ_CONFIGS:
        cfg_path = seq_cut_yaml(name, workdir)
        spans, losses, kept = {}, [], {}

        def timed(key):
            def wrap(real):
                def call(*a, **kw):
                    t0 = time.perf_counter()
                    res = real(*a, **kw)
                    sync(torch, dev)
                    spans[key] = spans.get(key, 0.0) + time.perf_counter() - t0
                    kept.setdefault(key, res)
                    return res
                return call
            return wrap

        def step_losses(real):
            def call(*a, **kw):
                losses.append(real(*a, **kw))
                return losses[-1]
            return call

        zero_counters()
        t0 = time.perf_counter()
        with wrapped(sq, "train_sequence_model", timed("train")), \
                wrapped(sq, "sequence_serving_predictions", timed("serve")), \
                wrapped(sq, "train_step", step_losses):
            train = (split.train if name == "gru"
                     else head_sessions(split.train, SEQ_CUT_TRAIN_SESSIONS))
            res = pipelines.run_sequence(train, target, N_AIDS, split.val_labels,
                                         config_path=str(cfg_path), device=dev)
        sync(torch, dev)
        total_s = time.perf_counter() - t0
        launches = read_counters(f"sequence path ({name})", ("fused_stage1", "peel_rows",
                                                              "aid_vote"))
        model = kept["train"]
        cfg = model.config
        seen = np.zeros(N_AIDS, bool)
        seen[train.aid] = True
        in_vocab = seen[target.last_aid()]
        routes = {"recency": int((counts >= 20).sum()),
                  "model": int(((counts < 20) & in_vocab).sum()),
                  "fallback": int(((counts < 20) & ~in_vocab).sum())}
        check(routes["recency"] > 0 and routes["model"] > 0, f"14b {name}: a route is empty")
        ls = torch.stack(losses).double().cpu().numpy()
        tenth = max(len(ls) // 10, 1)
        first, last = float(ls[:tenth].mean()), float(ls[-tenth:].mean())
        check(np.isfinite(ls).all() and last < first,
              f"14b {name}: the loss did not fall ({first} -> {last})")
        draw = seq_draw_ms(N_AIDS, cfg.batch_size, cfg.n_negatives)
        ms_step = 1e3 * spans["train"] / len(ls)
        r = res.report
        for t in TYPE_NAMES:
            p = res.predictions[t]
            check(p.shape == (target.n_sessions, 20) and p.min() >= -1 and p.max() < N_AIDS,
                  f"14b {name} {t}: prediction shape/range")
        check(0.0 < r.weighted < 1.0, f"14b {name}: weighted recall")
        out[name] = {"train_sessions": train.n_sessions, "total_s": total_s,
                     "train_s": spans["train"], "steps": len(ls),
                     "ms_a_step": ms_step, "draw_ms": draw, "host_draw_share": draw / ms_step,
                     "loss_first_tenth": first, "loss_last_tenth": last,
                     "serve_s": spans["serve"],
                     "sessions_per_s": target.n_sessions / spans["serve"],
                     "weighted": r.weighted, "launches": launches, "routes": routes,
                     "report": report_fields(r), "predictions": res.predictions, "model": model}
        print(f"14b run_sequence {name} ({train.n_sessions} training sessions; target "
              f"{target.n_sessions}, routes {routes}): {total_s:.2f} s; train_s "
              f"{spans['train']:.2f} "
              f"({len(ls)} steps, {ms_step:.3f} ms a step; the negative draw {draw:.3f} ms, "
              f"{100 * draw / ms_step:.1f}% of a step, on the host); loss {first:.4f} over the "
              f"first tenth -> {last:.4f} over the last; serve {spans['serve']:.2f} s "
              f"({target.n_sessions / spans['serve']:.0f} sessions/s); weighted recall@20 "
              f"{r.weighted:.6f} {report_fields(r)}", flush=True)
        if name != "gru":
            del out[name]["model"]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def seq_kernels_on_path(torch, dev, target, model, n_aids: int, n_recall: int = 2_000,
                        batch: int = 4096) -> dict:
    """Phase 14c: K1 and K3 against their twins on the operands the sequence
    path gives them, with their times and bounds.  K1: ``full_sort_topk``'s
    first batch of the model route ([4,096 x 3(64 + 2)] against the
    compensated [198 x N_pad] table), within 2^-15 relative with the same
    window position >= 0.999 (compare_kernels); then the lists of
    ``full_sort_topk`` against the exact ``topk_scan`` on ``n_recall``
    sessions (recall >= SEQ_RECALL).  K3: the recency route's input
    ([S, 256], the block kernel): ``first``/``firstpos`` bit-equal, ``agg``
    within 2^-16 * sum|w| of its row (the twin sums by einsum)."""
    from otto_tpu_torch.models.covisitation import session_unique_counts
    from otto_tpu_torch.ops import fused_retrieval as fr
    from otto_tpu_torch.ops import fused_sessions as fs
    from otto_tpu_torch.ops import sessions as ses
    from otto_tpu_torch.ops.retrieval import topk_scan

    counts = session_unique_counts(target)
    model_rows = np.flatnonzero(counts < 20)
    sub = target.select_sessions(model_rows[:batch])
    vecs = model.session_vectors(sub)
    items = model.params["item_emb"][:n_aids]
    retriever = fr.FusedRetriever(items, metric="dot", precision="compensated", device=dev)
    q_aug, _ = fr._augment_queries(vecs, retriever.max_sq, "dot")
    qhi, qlo = fr._bf16_split(q_aug)
    q = torch.cat([qhi, qhi, qlo], dim=1)
    t = retriever.items_aug_t
    k = fr.fused_stage1(q, t)
    r = fr._stage1_reference(q, t)
    live = r >= 1.0
    check(torch.equal(live, k >= 1.0), "14c K1: live windows differ from the twin")
    rel = float(((k - r).abs() / r.abs())[live].max())
    same = float(((k.view(torch.int32) & 127) == (r.view(torch.int32) & 127)).float().mean())
    k1_err = float((k - r).abs().max())
    check(rel <= 2.0**-15 and same >= 0.999,
          f"14c K1 [{tuple(q.shape)} x {tuple(t.shape)}]: rel err {rel}, same position {same}")
    del k, r
    if dev.type == "cuda":
        k1_ms = cuda_ms(torch, lambda: fr.fused_stage1(q, t), 10)
        k1_plain = cuda_ms(torch, lambda: fr._stage1_reference(q, t), 2)
        k1_ms = min(k1_ms, cuda_ms(torch, lambda: fr.fused_stage1(q, t), 10))
    else:
        k1_ms = _host_ms(lambda: fr.fused_stage1(q, t), 1)
        k1_plain = _host_ms(lambda: fr._stage1_reference(q, t), 1)
    k1_bound = stage1_bound(q, t)
    print(f"14c K1 on the sequence path's operands [{q.shape[0]} x {q.shape[1]}] x "
          f"[{t.shape[0]} x {t.shape[1]}] bf16: max rel err {rel:.3e} (limit 2^-15), same "
          f"window position {same:.6f} (limit 0.999); kernel {k1_ms:.3f} ms, twin "
          f"{k1_plain:.3f} ms; bound {k1_bound[0]:.3f} ms ({k1_bound[1]}): "
          f"{100 * k1_bound[0] / k1_ms:.1f}% of it", flush=True)
    k1 = {"shape": [int(q.shape[0]), int(q.shape[1]), int(t.shape[1])], "ms": k1_ms,
          "plain_ms": k1_plain, "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
          "max_abs_err": k1_err, "max_rel_err": rel, "same_position": same}
    del q, t, qhi, qlo, q_aug

    head = head_sessions(sub, n_recall)
    got = model.full_sort_topk(head, k=20)
    _, want = topk_scan(model.session_vectors(head), items, k=20, block=16384)
    want = want.cpu().numpy()
    recall = float(np.mean([len(set(a) & set(b)) / 20 for a, b in zip(got, want)]))
    check(recall >= SEQ_RECALL, f"14c full_sort_topk recall {recall} against the exact scan")
    print(f"14c full_sort_topk on {head.n_sessions} sessions: recall@20 {recall:.6f} against "
          f"the exact topk_scan (limit {SEQ_RECALL})", flush=True)

    packed = target.select_sessions(np.flatnonzero(counts >= 20)).pack(max_len=256, keep="last")

    def d(a):
        return torch.as_tensor(a, device=dev)

    mask = d(packed.mask)
    coef = torch.tensor([1.0, 6.0, 3.0], dtype=torch.float32, device=dev)
    w = ses.recency_event_weights(d(packed.aids), d(packed.types), mask, d(packed.lengths), coef)
    aids = torch.where(mask, d(packed.aids), -1).to(torch.int32)
    w = torch.where(mask, w, 0.0)
    ka, kf, kp = fs.aid_vote_aggregate(aids, w)
    ra, rf, rp = fs._vote_reference(aids, w)
    sync(torch, dev)
    check(torch.equal(kf, rf) and torch.equal(kp, rp),
          "14c K3: first/firstpos differ from the twin on the recency route's input")
    dd = (ka - ra).abs()
    check(bool((dd <= vote_bound(torch, w)).all()), "14c K3: agg beyond 2^-16 * sum|w|")
    k3_err, agg_equal = float(dd.max()), bool(torch.equal(ka, ra))
    S, L = aids.shape
    if dev.type == "cuda":
        k3_times = time_vote(torch, aids, w, 5)
    else:
        k3_times = {"ms": _host_ms(lambda: fs.aid_vote_aggregate(aids, w), 1),
                    "warm_ms": None, "plain_ms": _host_ms(lambda: fs._vote_reference(aids, w), 1)}
    k3_bound = vote_time_bound(torch, aids)
    print(f"14c K3 on the recency route's input [{S}, {L}] (the block kernel): first/firstpos "
          f"bit-equal, agg {'bit-equal' if agg_equal else f'max abs err {k3_err:.3e}'} "
          f"(limit 2^-16 * sum|w| of the row); bound {k3_bound[0]:.4f} ms ({k3_bound[1]}): "
          f"cold {100 * k3_bound[0] / k3_times['ms']:.1f}% of it", flush=True)
    k3 = {"shape": [S, L], "ms": k3_times["ms"], "warm_ms": k3_times["warm_ms"],
          "plain_ms": k3_times["plain_ms"], "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
          "max_abs_err": k3_err, "agg_bit_equal": agg_equal}
    return {"k1": k1, "k3": k3, "recall": recall}


def seq_cli(torch, dev, store, workdir: Path, trained: dict, zero_counters,
            read_counters) -> dict:
    """Phase 14d: ``sequence validation --config <sequence_gru.yaml, 1
    epoch>`` in process on ``store`` (14b's) as ``.jsonl``: if its report and
    lists equal 14b's gru run (a second training run of the same data: the
    card's training is then bit-reproducible), else held within 1e-3 of
    its weighted recall and named; ``sequence submission`` in a process of
    its own on the store's first SEQ_SUBMISSION_SESSIONS sessions (exit 0,
    a row a session and type); 14b's gru model saved and loaded back, its
    parameters bit-equal and its lists on 2,000 target sessions equal."""
    from otto_tpu_torch import pipelines
    from otto_tpu_torch.data import submission
    from otto_tpu_torch.data.splits import split_by_fraction
    from otto_tpu_torch.models import sequence as sq

    jsonl = workdir / "events.jsonl"
    write_jsonl(store, jsonl)
    cfg_path = seq_cut_yaml("gru", workdir)
    zero_counters()
    t0 = time.perf_counter()
    res = pipelines.main(["sequence", "validation", "--events", str(jsonl), "--config",
                          str(cfg_path), "--n-aids", str(N_AIDS), "--device", dev.type])
    sync(torch, dev)
    cli_s = time.perf_counter() - t0
    launches = read_counters("CLI sequence validation", ("fused_stage1", "peel_rows", "aid_vote"))
    ref = trained["gru"]
    same_report = report_fields(res.report) == ref["report"]
    same_lists = all(np.array_equal(res.predictions[t], ref["predictions"][t])
                     for t in TYPE_NAMES)
    print(f"14d CLI sequence validation (gru, 1 epoch) on the .jsonl: {cli_s:.2f} s, weighted "
          f"{res.report.weighted:.6f}; report equal to 14b's: {same_report}, lists equal: "
          f"{same_lists}", flush=True)
    if not (same_report and same_lists):
        rows = int((res.predictions["clicks"] != ref["predictions"]["clicks"]).any(axis=1).sum())
        print(f"14d: the card's training is not bit-reproducible: {rows} lists differ",
              flush=True)
        check(abs(res.report.weighted - ref["weighted"]) <= 1e-3,
              "14d: the CLI's weighted recall beyond 1e-3 of 14b's")

    head = head_sessions(store, SEQ_SUBMISSION_SESSIONS)
    head_jsonl = workdir / "events_head.jsonl"
    write_jsonl(head, head_jsonl)
    out = workdir / "sequence_submission.csv.gz"
    cmd = [sys.executable, "-m", "otto_tpu_torch.pipelines", "sequence", "submission",
           "--events", str(head_jsonl), "--config", str(cfg_path), "--n-aids", str(N_AIDS),
           "--output", str(out), "--device", dev.type]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    sub_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"{' '.join(cmd)} exited {proc.returncode}:\n{proc.stderr}")
    sub = submission.read_submission(out)
    check(all(len(sub[t]) == head.n_sessions for t in TYPE_NAMES)
          and set(sub["clicks"]) == set(head.session_ids.tolist()),
          "14d: the subprocess's submission does not hold a row a session and type")
    print(f"14d python -m otto_tpu_torch.pipelines sequence submission on {head.n_sessions} "
          f"sessions: exit 0 in {sub_s:.2f} s; {out.stat().st_size / 1e6:.2f} MB, "
          f"{3 * head.n_sessions} rows read back", flush=True)

    model = ref["model"]
    t0 = time.perf_counter()
    model.save(workdir / "gru.npz")
    loaded = sq.SequenceModel.load(workdir / "gru.npz", model.config, device=dev)
    save_load_s = time.perf_counter() - t0
    check(all(torch.equal(a, b) for a, b in zip(sq.tree_leaves(loaded.params),
                                                  sq.tree_leaves(model.params))),
          "14d: the loaded parameters differ from the saved ones")
    head = head_sessions(split_by_fraction(store).val_input, 2_000)
    same_saved = np.array_equal(loaded.full_sort_topk(head), model.full_sort_topk(head))
    check(same_saved, "14d: the saved and loaded model's lists differ")
    print(f"14d the gru model saved and loaded ({save_load_s:.2f} s): parameters bit-equal, "
          f"lists on 2,000 target sessions equal", flush=True)
    return {"cli_s": cli_s, "submission_s": sub_s, "bit_reproducible": same_report and same_lists,
            "launches": launches}


# ------------------------------------------------------------- phase 15
# Matrix factorization and collaborative filtering with the published
# configs (configs/matrix_factorization.yaml: 32 factors, MSE, lr 0.05
# halved every 5,000 steps, batch 262,144, a 14,571,582-session table over
# 1,855,604 aids; configs/collaborative_filtering.yaml: 32 factors, BCE, lr
# 5e-4 halved every 7,500 steps, 'diff' pairs over 1,855,603 aids), cut as
# MF_CUTS says.  No hand kernel: the step is torch ops (gathers, the
# closed-form gradient, index_add_ adagrad).
MF_CONFIG = REPO / "configs" / "matrix_factorization.yaml"
CF_CONFIG = REPO / "configs" / "collaborative_filtering.yaml"
MF_EPOCHS = 10  # 15b: epochs 250 -> 10 (at 20, phase 15 took 103 s on an H100)
MF_CHECK_EPOCHS = 2  # 15b: the card against the CPU
MF_FULL_EVENTS = 2  # 15c: events a session
MF_CUTS = ("15a: the tables and accumulators seeded, not trained; MF's batch is 262,144 of "
           "phase 7's (session, aid, type) rows, its sessions spread over the 14,571,582-row "
           "table (session s -> row 72 s)",
           f"15b: epochs 250 -> {MF_EPOCHS} (patience 20); phase 7's 180,000 training "
           "sessions (a 180,000-row session table), not the OTTO week's 14,571,582; the card "
           f"against a CPU run of the same config cut to {MF_CHECK_EPOCHS} epochs",
           f"15c: {MF_FULL_EVENTS} events a session (OTTO has ~15), the aids and types drawn "
           "from phase 7's events; one epoch, no save")
# 15a-15b: card against CPU, each touched table and accumulator entry within
# MF_RTOL * (|cpu| + MF_FLOOR) (the SGNS steps' bar: the card's atomics add a
# row's duplicates in another order), a step's loss and each epoch's
# train and validation loss within MF_LOSS_RTOL relative.
MF_RTOL, MF_FLOOR, MF_LOSS_RTOL = 1e-4, 1e-2, 1e-5


def mf_configs():
    from otto_tpu_torch.config import CFConfig, MFConfig

    return MFConfig.from_yaml(MF_CONFIG), CFConfig.from_yaml(CF_CONFIG)


def mf_step_bytes(batch, D: int, lookups) -> tuple[float, float]:
    """A sparse step's bytes as the code moves them, and the unique-row
    floor.  The code, for each of the two lookups of B rows: the gather
    (B x D read), the accumulator's index_add_ (read and write), its
    re-read at the rows, the table's index_add_ (read and write): 6 B D
    float32; plus the batch's three columns.  The floor: each distinct row
    of each table and accumulator read once and written once."""
    B = len(batch[0])
    cols = sum(np.asarray(c).nbytes for c in batch)
    code = 2 * 6 * B * D * 4 + cols
    rows = {}
    for table, col in lookups:
        rows.setdefault(table, []).append(np.asarray(batch[col]))
    distinct = sum(len(np.unique(np.concatenate(r))) for r in rows.values())
    return code, distinct * D * 4 * 4 + cols


def mf_steps(torch, dev, store, reps: int = 20) -> list[dict]:
    """Phase 15a: one sparse adagrad step of each published config at full
    table height, card against CPU on the same tables and batch: MF over a
    14,571,582 x 32 session table and a 1,855,604 x 32 aid table, CF over
    one 1,855,603 x 32 table with both lookups into it (phase 7's
    ``cf_pairs_diff`` pairs, so the hot aids repeat within a batch as they
    do in training).  The touched rows are compared; then ms a step on the
    card (CUDA events over ``reps`` steps) against the bytes the code moves
    at 3.35 TB/s."""
    from otto_tpu_torch.models import matrix_factorization as tmf

    mf, cf = mf_configs()
    B, D = mf.batch_size, mf.n_factors
    rng = np.random.default_rng(SEED + 15)
    rows = rng.choice(store.n_events, B, replace=False)
    spread = mf.n_sessions // store.n_sessions
    mf_batch = ((store.session_idx[rows] * spread).astype(np.int32), store.aid[rows].astype(np.int32),
                store.type[rows].astype(np.float32))
    x1, x2, y = tmf.cf_pairs_diff(store, np.random.default_rng(cf.seed))
    sel = rng.choice(len(y), B, replace=False)
    cases = {"mf": (mf, {"session_embeddings": mf.n_sessions, "aid_embeddings": mf.n_aids},
                    (("session_embeddings", 0), ("aid_embeddings", 1)), mf_batch),
             "cf": (cf, {"embeddings": cf.n_aids}, (("embeddings", 0), ("embeddings", 1)),
                    (x1[sel], x2[sel], y[sel]))}
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    out = []
    for name, (cfg, heights, lookups, batch) in cases.items():
        tables = {k: torch.randn((h, D), generator=gen, device=dev).mul_(0.05)
                  for k, h in heights.items()}
        accs = {k: torch.rand((h, D), generator=gen, device=dev).mul_(1e-10)
                for k, h in heights.items()}
        host = tuple({k: v.to("cpu", copy=True) for k, v in d.items()} for d in (tables, accs))
        lr = tmf.lr_at(cfg, 0)
        l_dev = float(tmf.sparse_step(tables, accs, lookups, cfg.loss, lr,
                                      *(torch.as_tensor(c, device=dev) for c in batch)))
        l_cpu = float(tmf.sparse_step(*host, lookups, cfg.loss, lr,
                                      *(torch.as_tensor(c) for c in batch)))
        worst, err = 0.0, 0.0
        for k in heights:
            idx = np.unique(np.concatenate([batch[c] for t, c in lookups if t == k]))
            idx_d = torch.as_tensor(idx, device=dev)
            for card, cpu in ((tables, host[0]), (accs, host[1])):
                a, b = card[k][idx_d].cpu().double(), cpu[k][torch.as_tensor(idx)].double()
                diff = (a - b).abs()
                worst = max(worst, float((diff / (b.abs() + MF_FLOOR)).max()))
                err = max(err, float(diff.max()))
        loss_rel = abs(l_dev - l_cpu) / abs(l_cpu)
        check(worst <= MF_RTOL, f"15a {name} step: card vs CPU {worst:.3e} > {MF_RTOL}")
        check(loss_rel <= MF_LOSS_RTOL, f"15a {name} step: loss {l_dev} vs CPU {l_cpu}")
        del host
        b_dev = [torch.as_tensor(c, device=dev) for c in batch]
        def run():
            return tmf.sparse_step(tables, accs, lookups, cfg.loss, lr, *b_dev)

        ms = cuda_ms(torch, run, reps) if dev.type == "cuda" else _host_ms(run, 2)
        code_bytes, floor_bytes = mf_step_bytes(batch, D, lookups)
        b_ms = code_bytes / HBM_BYTES_PER_S * 1e3
        floor_ms = floor_bytes / HBM_BYTES_PER_S * 1e3
        dup = {f"col{c}": [len(np.unique(batch[c])), int(np.bincount(batch[c]).max())]
               for _, c in lookups}
        shapes = ", ".join(f"{k} {h:,} x {D}" for k, h in heights.items())
        print(f"15a {name} step [{B} x {D}] over {shapes} (distinct rows and the largest "
              f"repeat a column: {dup}): card vs CPU max |diff|/(|cpu| + {MF_FLOOR}) "
              f"{worst:.3e} (limit {MF_RTOL}), max abs {err:.3e}, loss rel {loss_rel:.2e} "
              f"(limit {MF_LOSS_RTOL}); {ms:.4f} ms a step; bound {b_ms:.4f} ms (bytes: "
              f"{code_bytes / 1e6:.1f} MB as the code moves them): {100 * b_ms / ms:.1f}% of "
              f"it; the unique-row floor {floor_ms:.4f} ms ({100 * floor_ms / ms:.1f}%)",
              flush=True)
        out.append({"step": name, "ms": ms, "bound_ms": b_ms, "bound_by": "bytes",
                    "bytes": code_bytes, "share": b_ms / ms, "floor_ms": floor_ms,
                    "max_rel_err": worst, "loss_rel": loss_rel})
        del tables, accs, b_dev, run
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def mf_card_vs_cpu(torch, dev, train, name: str, cfg) -> float:
    """15b: the config cut to MF_CHECK_EPOCHS on the card and on the CPU:
    the same epochs, each loss within MF_LOSS_RTOL relative, the tables
    within MF_RTOL * (|cpu| + MF_FLOOR); returns the worst table error."""
    from otto_tpu_torch.models import matrix_factorization as tmf

    fn = tmf.train_mf if name == "mf" else tmf.train_cf
    short = cfg.replace(epochs=MF_CHECK_EPOCHS)
    card, cpu = (fn(train, cfg.n_aids, short, device=d) for d in (dev, "cpu"))
    check([h["epoch"] for h in card.history] == [h["epoch"] for h in cpu.history],
          f"15b {name}: card epochs {card.history} vs CPU {cpu.history}")
    for hd, hc in zip(card.history, cpu.history):
        for key in ("train_loss", "val_loss"):
            check(abs(hd[key] - hc[key]) <= MF_LOSS_RTOL * abs(hc[key]),
                  f"15b {name} {key}: card {hd} vs CPU {hc}")
    names = ("session_embeddings", "aid_embeddings") if name == "mf" else ("embeddings",)
    worst = 0.0
    for n in names:
        a, b = getattr(card, n).astype(np.float64), getattr(cpu, n).astype(np.float64)
        worst = max(worst, float((np.abs(a - b) / (np.abs(b) + MF_FLOOR)).max()))
    check(worst <= MF_RTOL, f"15b {name}: card tables vs CPU {worst:.3e} > {MF_RTOL}")
    return worst


def mf_training(torch, dev, split, workdir: Path) -> dict:
    """Phase 15b: ``train_mf`` and ``train_cf`` with the published configs,
    epochs cut to MF_EPOCHS, on phase 7's training sessions over the full
    catalog: the host's pair building, ``train_s``, steps, ms a step,
    samples/s, the training loss (it must fall) and the validation loss
    (first epoch against best), MF's regression scores and CF's classification scores on their
    validation rows; the card against the CPU (``mf_card_vs_cpu``); both
    models saved (the reference's compressed npz, written at once by two
    threads) and loaded back equal."""
    import threading

    from otto_tpu_torch.eval.model_metrics import classification_scores, regression_scores
    from otto_tpu_torch.models import matrix_factorization as tmf

    res, models = {}, {}
    for name, cfg in zip(("mf", "cf"), mf_configs()):
        cfg = cfg.replace(epochs=MF_EPOCHS)
        fn = tmf.train_mf if name == "mf" else tmf.train_cf
        stats = {}
        model = fn(split.train, cfg.n_aids, cfg, device=dev, stats_out=stats)
        val = [h["val_loss"] for h in model.history]
        best = int(np.argmin(val))
        tl = [h["train_loss"] for h in model.history]
        check(all(np.isfinite(val + tl)) and tl[-1] < tl[0],
              f"15b {name}: the training loss did not fall: {model.history}")
        v = stats["val"]
        if name == "mf":
            pred = np.sum(model.session_embeddings[v[0]] * model.aid_embeddings[v[1]], axis=1)
            scores = regression_scores(v[2], pred)
        else:
            scores = classification_scores(v[2], model.score_pairs(v[0], v[1]))
        check(all(np.isfinite(x) for x in scores.values()), f"15b {name}: scores {scores}")
        samples_per_s = stats["steps"] * cfg.batch_size / stats["train_s"]
        worst = mf_card_vs_cpu(torch, dev, split.train, name, cfg)
        res[name] = {"pairs_s": stats["pairs_s"], "samples": stats["samples"],
                     "train_s": stats["train_s"], "steps": stats["steps"],
                     "epochs": len(model.history),
                     "ms_a_step": 1e3 * stats["train_s"] / stats["steps"],
                     "samples_per_s": samples_per_s, "train_first_last": [tl[0], tl[-1]],
                     "val_first": val[0],
                     "val_best": val[best], "best_epoch": best, "scores": scores,
                     "card_vs_cpu": worst}
        print(f"15b train_{name}: {stats['samples']:,} samples (built on the host in "
              f"{stats['pairs_s']:.2f} s), {stats['steps']} steps over {len(val)} epochs in "
              f"{stats['train_s']:.2f} s: {res[name]['ms_a_step']:.2f} ms a step, "
              f"{samples_per_s:,.0f} samples/s; training loss {tl[0]:.5f} -> {tl[-1]:.5f}, "
              f"validation loss {val[0]:.5f} (epoch 0) -> "
              f"{val[best]:.5f} (best, epoch {best}); {scores}; card vs CPU at "
              f"{MF_CHECK_EPOCHS} epochs: tables within {worst:.2e} of (|x| + {MF_FLOOR})",
              flush=True)
        models[name] = model
    t0 = time.perf_counter()
    paths = {k: workdir / f"{k}.npz" for k in models}
    savers = [threading.Thread(target=m.save, args=(paths[k],)) for k, m in models.items()]
    for s in savers:
        s.start()
    for s in savers:
        s.join()
    save_s = time.perf_counter() - t0
    mf_back, cf_back = tmf.MFModel.load(paths["mf"]), tmf.CFModel.load(paths["cf"])
    check(np.array_equal(mf_back.session_embeddings, models["mf"].session_embeddings)
          and np.array_equal(mf_back.aid_embeddings, models["mf"].aid_embeddings)
          and np.array_equal(cf_back.embeddings, models["cf"].embeddings),
          "15b: a saved model loaded back differs")
    print(f"15b both models saved ({', '.join(f'{p.stat().st_size / 1e6:.0f} MB' for p in paths.values())}) "
          f"in {save_s:.2f} s and loaded back equal", flush=True)
    res["save_s"] = save_s
    res["mf_model"] = models["mf"]
    return res


def mf_full_height(torch, dev, store) -> dict:
    """Phase 15c: ``train_mf`` with configs/matrix_factorization.yaml for
    one epoch at the reference's full table shape: a store of 14,571,582
    sessions of MF_FULL_EVENTS events, aids and types drawn from phase 7's
    events; ``train_s``, samples/s, the card's peak memory, finite
    tables."""
    from otto_tpu_torch.data.events import EventStore
    from otto_tpu_torch.models import matrix_factorization as tmf
    from otto_tpu_torch.utils.profiling import device_memory_stats

    cfg = mf_configs()[0].replace(epochs=1)
    S, L = cfg.n_sessions, MF_FULL_EVENTS
    rng = np.random.default_rng(SEED + 16)
    pick = rng.integers(0, store.n_events, S * L)
    big = EventStore(np.repeat(np.arange(S, dtype=np.int32), L), store.aid[pick],
                     np.zeros(S * L, np.int64), store.type[pick],
                     np.arange(0, S * L + 1, L, dtype=np.int64), np.arange(S, dtype=np.int64))
    del pick
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    stats = {}
    t0 = time.perf_counter()
    model = tmf.train_mf(big, cfg.n_aids, cfg, device=dev, stats_out=stats)
    total_s = time.perf_counter() - t0
    mem = device_memory_stats(dev)
    shapes = (model.session_embeddings.shape, model.aid_embeddings.shape)
    check(shapes == ((S, cfg.n_factors), (cfg.n_aids, cfg.n_factors)), f"15c shapes {shapes}")
    finite = bool(np.isfinite(model.session_embeddings).all()
                  and np.isfinite(model.aid_embeddings).all())
    check(finite, "15c: non-finite tables")
    h = model.history[0]
    check(np.isfinite(h["val_loss"]) and np.isfinite(h["train_loss"]), f"15c loss {h}")
    rate = stats["steps"] * cfg.batch_size / stats["train_s"]
    print(f"15c train_mf at full height: {stats['samples']:,} samples, tables {shapes}, "
          f"{stats['steps']} steps in {stats['train_s']:.2f} s ({total_s:.2f} s with "
          f"mf_samples): {1e3 * stats['train_s'] / stats['steps']:.2f} ms a step, "
          f"{rate:,.0f} samples/s; train loss {h['train_loss']:.5f}, validation "
          f"{h['val_loss']:.5f}; the card's peak {mem.get('peak_bytes_in_use', 0) / 2**30:.2f} "
          f"GiB of {mem.get('bytes_limit', 0) / 2**30:.1f}; tables finite: {finite}", flush=True)
    return {"samples": stats["samples"], "train_s": stats["train_s"], "steps": stats["steps"],
            "samples_per_s": rate, "peak_bytes": mem.get("peak_bytes_in_use"),
            "train_loss": h["train_loss"], "val_loss": h["val_loss"], "finite": finite}


def mf_utilities(torch, dev, split, mf_model, step15a: dict, workdir: Path) -> dict:
    """Phase 15d: the training utilities on card tensors.  The MF state of
    15b (its tables, fresh accumulators) under a ``TrainingGuard`` saving
    every 2 steps: a NaN planted in the aid table before step 5 makes the
    loss non-finite, the guard rolls back to step 4, and the restored
    tensors (on the card) equal the checkpoint's; then ``trace`` over 3
    steps writes a profile; then ``roofline()`` of 15a's MF step gives the
    share 15a printed."""
    from otto_tpu_torch.models import matrix_factorization as tmf
    from otto_tpu_torch.utils.checkpoint import CheckpointManager
    from otto_tpu_torch.utils.failure import TrainingGuard, nonfinite_count
    from otto_tpu_torch.utils.profiling import trace
    from otto_tpu_torch.utils.roofline import roofline

    cfg = mf_configs()[0]
    cols = tmf.mf_samples(split.train)
    lookups = (("session_embeddings", 0), ("aid_embeddings", 1))
    tables = {"session_embeddings": torch.as_tensor(mf_model.session_embeddings, device=dev),
              "aid_embeddings": torch.as_tensor(mf_model.aid_embeddings, device=dev)}
    state = {"tables": tables, "accs": {k: torch.zeros_like(t) for k, t in tables.items()}}
    rng = np.random.default_rng(SEED + 17)

    def batch():
        sel = rng.integers(0, len(cols[0]), cfg.batch_size)
        return [torch.as_tensor(c[sel], device=dev) for c in cols]

    def step(st, b, i):
        return tmf.sparse_step(st["tables"], st["accs"], lookups, cfg.loss, tmf.lr_at(cfg, i), *b)

    mgr = CheckpointManager(workdir / "guard", max_to_keep=2)
    guard = TrainingGuard(mgr, save_every=2)
    i, planted, restored_equal = 0, 0, False
    t0 = time.perf_counter()
    while i < 6:
        i += 1
        b = batch()
        if i == 5 and not planted:
            state["tables"]["aid_embeddings"][b[1][:1]] = float("nan")
            planted = int(nonfinite_count(state))
        state, i, ok = guard.observe(i, state, step(state, b, i))
        if not ok:
            check(i == 4, f"15d: rolled back to step {i}, not 4")
            saved = mgr.restore(4)
            restored_equal = all(t.device == dev and torch.equal(t.cpu(), saved[part][k])
                                 for part in ("tables", "accs") for k, t in state[part].items())
    guard_s = time.perf_counter() - t0
    check(planted == cfg.n_factors, f"15d: planted {planted} NaNs")
    check(guard.rollbacks == 1 and guard.failures[0]["step"] == 5 and restored_equal,
          f"15d: rollbacks {guard.rollbacks}, failures {guard.failures}, restored equal "
          f"{restored_equal}")
    check(int(nonfinite_count(state)) == 0, "15d: the state after the rollback is not finite")
    print(f"15d TrainingGuard: {planted} NaNs planted before step 5, the loss non-finite, "
          f"rolled back to step 4 on the card (restored tensors equal the checkpoint's), "
          f"steps 5-6 replayed finite; {guard_s:.2f} s with 3 checkpoints of "
          f"{sum(t.numel() * 4 for p in state.values() for t in p.values()) / 1e6:.0f} MB",
          flush=True)

    with trace(workdir / "trace") as prof:
        for j in range(3):
            step(state, batch(), 7 + j)
        sync(torch, dev)
    files = list((workdir / "trace").glob("*.json"))
    check(len(files) == 1 and files[0].stat().st_size > 0, f"15d: trace files {files}")
    events = prof.key_averages()
    device_us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                    for e in events)
    print(f"15d trace of 3 MF steps: {files[0].name}, {files[0].stat().st_size / 1e6:.1f} MB, "
          f"{len(events)} operations, device time {device_us / 1e3:.3f} ms "
          f"({device_us / 3e3:.3f} ms a step)", flush=True)

    r = roofline(step15a["ms"] / 1e3, hbm_bytes=step15a["bytes"], device=dev)
    check(abs(r["hbm_frac"] - step15a["share"]) <= 5e-5,
          f"15d: roofline {r} vs 15a's share {step15a['share']}")
    print(f"15d roofline() of 15a's MF step: {r} (15a: {step15a['share']:.4f})", flush=True)
    return {"guard_s": guard_s, "trace_mb": files[0].stat().st_size / 1e6,
            "trace_device_ms_a_step": device_us / 3e3, "roofline": r}


# ------------------------------------------------------------- phase 16
# Sharded serving and the row-sharded tables on the card
# (otto_tpu_torch.parallel).  16a: one NCCL rank, mesh (1, 1), in this
# process, against the single-device calls; 16b: two ranks sharing the one
# card under gloo (NCCL refuses two ranks on one device), meshes (1, 2) and
# (2, 1), against 16a's results, passed with the inputs as files under
# MESH_DIR.  Widths are the full ones: phase 6's bench data, phase 7's
# 1,855,603-aid tables and target sessions with phase 4's neighbor table,
# phase 3's table, 15a's MF batch and table heights, 12a's SGNS batch, 13a's
# tower shape.
MESH_DIR = REPO / "tmp" / "chip_smoke_mesh"
MESH_K = K_NNS
MESH_SGNS = {"batch": 8192, "negatives": 40, "lr": 0.05}
MESH_TOWER = (4096, 184)  # 13a's forward shape, 55 features
MESH_CUTS = ("16b: the covisitation build runs at mesh (2, 1) only (at (1, 2) each rank would "
             "repeat the whole single-device build: the build shards sessions over data)",)
MESH_RECALL = 0.99  # sharded_topk against the exact scan (phase 3's bound)
# 16b: a rank's table bytes (the MF shards, the serving tables, the kNN
# table's retriever) against 16a's whole tables: about half at mesh (1, 2),
# the whole at (2, 1)
MESH_HALF_BAND = (0.45, 0.55)
MESH_WHOLE_BAND = (0.95, 1.05)
MESH_TABLE_BYTES = ("mf_shard_bytes", "serving_table_bytes", "knn_table_bytes")
# the serving entry points' default widths: regular_candidates' wide_k,
# covisit_heuristic_predictions' narrow_k
SERVE_WIDE_K, SERVE_NARROW_K = 20, 15


def mesh_env() -> dict:
    """torchrun's environment for one rank of a one-process group."""
    from otto_tpu_torch.parallel.mesh import free_port

    return {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(free_port())}


def mesh_mf_tables(torch, dev):
    """15a's MF heights, seeded on the card (the same values in every
    process on this card)."""
    mf = mf_configs()[0]
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    D = mf.n_factors
    tables = [torch.randn((h, D), generator=gen, device=dev).mul_(0.05)
              for h in (mf.n_sessions, mf.n_aids)]
    accs = [torch.rand((h, D), generator=gen, device=dev).mul_(1e-10)
            for h in (mf.n_sessions, mf.n_aids)]
    return tables + accs


def mesh_sgns_tables(torch, dev, n_aids: int):
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    w_in = torch.rand((n_aids, DIM), generator=gen, device=dev).sub_(0.5).div_(DIM)
    w_out = torch.randn((n_aids, DIM), generator=gen, device=dev).mul_(0.1)
    accs = [torch.rand((n_aids, DIM), generator=gen, device=dev).mul_(1e-3) for _ in range(2)]
    return [w_in, w_out, *accs]


def mesh_tower(torch):
    """Two folds of 13a's tower (seeded) and 13a's feature rows."""
    from otto_tpu_torch.config import RankerConfig
    from otto_tpu_torch.features import RANKER_FEATURES
    from otto_tpu_torch.models.ranker import FeatureNormalizer, RankerModel

    cfg = RankerConfig.from_yaml(TOWER_CONFIG)
    F = len(RANKER_FEATURES) + 1
    S, C = MESH_TOWER
    x = (np.random.default_rng(SEED + 13).normal(size=(S, C, F)) * 3).astype(np.float32)
    mask = np.random.default_rng(SEED + 14).random((S, C)) < 0.9
    folds = [{k: v.numpy() for k, v in seeded_tower(torch, F, cfg.hidden_dims, s).items()}
             for s in (SEED, SEED + 1)]
    return RankerModel(folds, FeatureNormalizer.fit(x[:512], mask[:512]), cfg), x, mask


def touched_close(torch, got, want_rows, idx, lo: int) -> float:
    """Largest |got - want| / (|want| + MF_FLOOR) over the global rows
    ``idx`` that this rank's block (first row ``lo``) holds."""
    own = (idx >= lo) & (idx < lo + got.shape[0])
    if not own.any():
        return 0.0
    a = got[torch.as_tensor(idx[own] - lo, device=got.device)].cpu().double()
    b = torch.as_tensor(want_rows[own]).double()
    return float(((a - b).abs() / (b.abs() + MF_FLOOR)).max())


def mesh_inputs(torch, dev, bench_train, bench_aids: int, phase7: dict, work: Path) -> dict:
    """Phase 16's inputs, written under ``work`` for the 16b ranks (the
    tables as .npy files each rank maps, reading its own rows)."""
    from otto_tpu_torch import EVENT_TYPES
    from otto_tpu_torch.models.frequency import FrequencyStatistics

    rng = np.random.default_rng(SEED + 16)
    stats = FrequencyStatistics.compute(phase7["train"], n_aids=N_AIDS, device=dev)
    n_aids = phase7["w_in"].shape[0]
    qi = rng.choice(n_aids, 4096, replace=False)
    mf = mf_configs()[0]
    store = phase7["store"]
    rows = np.random.default_rng(SEED + 15).choice(store.n_events, mf.batch_size, replace=False)
    spread = mf.n_sessions // store.n_sessions
    ids = rng.permutation(n_aids)[:MESH_SGNS["batch"] * (MESH_SGNS["negatives"] + 2)]
    B, K = MESH_SGNS["batch"], MESH_SGNS["negatives"]
    inp = {"qi": qi, "mf_si": (store.session_idx[rows] * spread).astype(np.int32),
           "mf_ai": store.aid[rows].astype(np.int32), "mf_y": store.type[rows].astype(np.float32),
           "sgns_c": ids[:B], "sgns_x": ids[B:2 * B],
           "sgns_negs": ids[2 * B:].reshape(B, K), "bench_n_aids": np.int64(bench_aids),
           **{f"stats_{t}": np.asarray(stats.top_by_type[t]) for t in EVENT_TYPES}}
    work.mkdir(parents=True, exist_ok=True)
    np.savez(work / "inputs.npz", **inp)
    bench_train.save_npz(work / "bench_train.npz")
    phase7["target"].save_npz(work / "target7.npz")
    np.save(work / "ft.npy", phase7["ft"])
    np.save(work / "w_in.npy", phase7["w_in"].cpu().numpy())
    for kind, (a, _) in phase7["mats"].tables.items():
        np.save(work / f"mats7_{kind}.npy", np.ascontiguousarray(a[:, :20]))
    return inp


def mesh_load(work: Path) -> dict:
    """What a 16b rank reads: the stores, the tables as maps, the batches."""
    from otto_tpu_torch.config import COVISIT_KINDS
    from otto_tpu_torch.data.events import EventStore
    from otto_tpu_torch.models.covisitation import CovisitationMatrices

    inp = dict(np.load(work / "inputs.npz"))
    tabs = {k: np.load(work / f"mats7_{k}.npy", mmap_mode="r") for k in COVISIT_KINDS}
    n_aids = tabs[COVISIT_KINDS[0]].shape[0]
    no_weights = np.zeros((n_aids, 0), np.float32)  # serving reads the ids alone
    return {**inp, "bench_train": EventStore.load_npz(work / "bench_train.npz"),
            "target7": EventStore.load_npz(work / "target7.npz"),
            "ft": np.load(work / "ft.npy", mmap_mode="r"),
            "w_in": np.load(work / "w_in.npy", mmap_mode="r"),
            "mats7": CovisitationMatrices({k: (a, no_weights) for k, a in tabs.items()}, n_aids)}


def mesh_single(torch, dev, inp: dict, phase7: dict, bench_mats) -> dict:
    """16a's single-device results on the card, each call timed."""
    from otto_tpu_torch import EVENT_TYPES
    from otto_tpu_torch.models.candidates import regular_candidates
    from otto_tpu_torch.models.covisitation import covisit_heuristic_predictions
    from otto_tpu_torch.models.embeddings import sgns_step
    from otto_tpu_torch.models.matrix_factorization import sparse_step
    from otto_tpu_torch.ops.fused_retrieval import FusedRetriever
    from otto_tpu_torch.ops.retrieval import topk_scan

    ref, secs = {}, {}
    for kind, (a, w) in bench_mats.tables.items():
        ref[f"build_{kind}_ids"], ref[f"build_{kind}_w"] = a, w
    top = {t: inp[f"stats_{t}"] for t in EVENT_TYPES}
    t0 = time.perf_counter()
    cs = regular_candidates(phase7["target"], phase7["mats"], ft_neighbors=phase7["ft"],
                            device=dev)
    secs["candidates"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    heur = covisit_heuristic_predictions(phase7["target"], phase7["mats"], top,
                                         ft_neighbors=phase7["ft"], device=dev)
    secs["heuristic"] = time.perf_counter() - t0
    for t in EVENT_TYPES:
        ref[f"cand_{t}"], ref[f"score_{t}"] = cs.candidates[t], cs.scores[t]
        ref[f"heur_{t}"] = heur[t]
    w_in = phase7["w_in"]
    q = w_in[torch.as_tensor(inp["qi"], device=dev)]
    sync(torch, dev)
    t0 = time.perf_counter()
    s, i = FusedRetriever(w_in, metric="euclidean", precision="compensated",
                          device=dev).topk(q, MESH_K, exact_scores=True)
    sync(torch, dev)
    secs["topk"] = time.perf_counter() - t0
    ref["topk_s"], ref["topk_i"] = s.cpu().numpy(), i.cpu().numpy()
    ref["exact_i"] = topk_scan(q, w_in, k=MESH_K, metric="euclidean")[1].cpu().numpy()

    mf = mf_configs()[0]
    tabs = mesh_mf_tables(torch, dev)
    batch = [torch.as_tensor(inp[k], device=dev) for k in ("mf_si", "mf_ai", "mf_y")]
    names = ("session_embeddings", "aid_embeddings")
    tables, accs = dict(zip(names, tabs[:2])), dict(zip(names, tabs[2:]))
    loss = sparse_step(tables, accs, ((names[0], 0), (names[1], 1)), mf.loss,
                       tmf_lr(mf), *batch)
    ref["mf_loss"] = np.float32(float(loss))
    for j, (k, col) in enumerate(((names[0], "mf_si"), (names[1], "mf_ai"))):
        idx = np.unique(inp[col])
        ref[f"mf_idx{j}"] = idx
        ref[f"mf_t{j}"] = tables[k][torch.as_tensor(idx, device=dev)].cpu().numpy()
        ref[f"mf_a{j}"] = accs[k][torch.as_tensor(idx, device=dev)].cpu().numpy()
    del tabs, tables, accs

    w = mesh_sgns_tables(torch, dev, w_in.shape[0])
    loss = sgns_step(*w, *(torch.as_tensor(inp[k], device=dev).long()
                           for k in ("sgns_c", "sgns_x", "sgns_negs")), MESH_SGNS["lr"])
    ref["sgns_loss"] = np.float32(float(loss) * MESH_SGNS["batch"])
    out_idx = np.concatenate([inp["sgns_x"], inp["sgns_negs"].reshape(-1)])
    for j, idx in ((0, inp["sgns_c"]), (1, out_idx), (2, inp["sgns_c"]), (3, out_idx)):
        ref[f"sgns_idx{j}"] = idx
        ref[f"sgns_{j}"] = w[j][torch.as_tensor(idx, device=dev)].cpu().numpy()
    del w
    model, x, mask = mesh_tower(torch)
    t0 = time.perf_counter()
    ref["tower"] = model.predict(x, mask, device=dev)
    secs["tower"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    print("16a single-device calls: " + json.dumps(
        {k: round(v, 3) for k, v in secs.items()}), flush=True)
    return ref


def tmf_lr(cfg) -> float:
    from otto_tpu_torch.models import matrix_factorization as tmf

    return tmf.lr_at(cfg, 0)


def mesh_run(torch, mesh, inp: dict, ref: dict, counters, build: bool, tag: str,
             reps: int = 5) -> dict:
    """Every sharded call of this slice on ``mesh``, held to the
    single-device results ``ref``: the build's ids equal and weights within
    1e-5 relative; candidates and heuristic lists bit-equal, scores within
    1e-5 relative; the bytes of the serving tables as the entry points
    place them and of the kNN table's :class:`ShardedRetriever`;
    ``ShardedRetriever.topk``'s ids equal to ``FusedRetriever.topk``'s on
    one shard (the scores of the ids both keep, within 1e-5 of the largest,
    on more), the ids it keeps from this rank's block a prefix of
    ``FusedRetriever.topk``'s on the block alone, K1 and K2 launched, recall
    against the exact scan >= 0.99; the lookup bit-equal; the MF and SGNS steps' touched rows within MF_RTOL * (|x| +
    MF_FLOOR) of the single-card steps and their losses within MF_LOSS_RTOL;
    the tower's scores equal (bit-equality reported).  The steps' ms are
    the mean of ``reps`` steps after one more (one step, unwarmed, for
    ``reps=1``).  Returns the seconds, launches and errors."""
    from otto_tpu_torch import EVENT_TYPES
    from otto_tpu_torch.config import COVISIT_KINDS
    from otto_tpu_torch.models.candidates import regular_candidates
    from otto_tpu_torch.models.covisitation import (
        build_covisitation,
        covisit_heuristic_predictions,
    )
    from otto_tpu_torch.ops.fused_retrieval import FusedRetriever
    from otto_tpu_torch.parallel import (
        CANDGEN_TABLE_KINDS,
        ServingLayout,
        ShardedRetriever,
        make_sharded_mf_step,
        make_sharded_sgns_step,
        mesh_device,
        shard_rows,
        sharded_lookup,
    )
    from otto_tpu_torch.parallel.mesh import axis_index, axis_size

    dev = mesh_device(mesh)

    def allocated():
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated(dev)

    out = {"secs": {}}
    secs = out["secs"]
    zero, read = counters
    if build:
        t0 = time.perf_counter()
        mats = build_covisitation(inp["bench_train"], int(inp["bench_n_aids"]), mesh=mesh,
                                  device=dev)
        secs["build"] = time.perf_counter() - t0
        for kind in COVISIT_KINDS:
            a, w = mats.tables[kind]
            check(np.array_equal(a, ref[f"build_{kind}_ids"]), f"16 {tag} build {kind}: ids")
            check(bool(np.allclose(w, ref[f"build_{kind}_w"], rtol=1e-5, atol=0)),
                  f"16 {tag} build {kind}: weights beyond 1e-5")
    top = {t: inp[f"stats_{t}"] for t in EVENT_TYPES}
    t0 = time.perf_counter()
    cs = regular_candidates(inp["target7"], inp["mats7"], ft_neighbors=inp["ft"], mesh=mesh,
                            device=dev)
    secs["candidates"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    heur = covisit_heuristic_predictions(inp["target7"], inp["mats7"], top,
                                         ft_neighbors=inp["ft"], mesh=mesh, device=dev)
    secs["heuristic"] = time.perf_counter() - t0
    for t in EVENT_TYPES:
        check(np.array_equal(cs.candidates[t], ref[f"cand_{t}"]), f"16 {tag} candidates {t}")
        check(bool(np.allclose(cs.scores[t], ref[f"score_{t}"], rtol=1e-5, atol=0)),
              f"16 {tag} candidate scores {t}")
        check(np.array_equal(heur[t], ref[f"heur_{t}"]), f"16 {tag} heuristic {t}")
    out["scores_bit_equal"] = all(np.array_equal(cs.scores[t], ref[f"score_{t}"])
                                  for t in EVENT_TYPES)
    del cs, heur

    # the tables both serving calls place on this rank, as they place them
    layout = ServingLayout(mesh)
    tabs = inp["mats7"].tables
    before = allocated()
    placed = [layout.table(tabs[kind][0][:, :SERVE_WIDE_K]) for kind in CANDGEN_TABLE_KINDS]
    placed += [layout.table(a[:, :SERVE_NARROW_K]) for a, _ in tabs.values()]
    placed += [layout.table(inp["ft"])]
    out["serving_table_bytes"] = allocated() - before
    del placed

    q = torch.as_tensor(np.asarray(inp["w_in"][inp["qi"]]), device=dev)
    before = allocated()
    t0 = time.perf_counter()
    block = shard_rows(mesh, inp["w_in"])
    retriever = ShardedRetriever(mesh, block, metric="euclidean")
    sync(torch, dev)
    secs["sharded_retriever_build"] = time.perf_counter() - t0
    out["knn_table_bytes"] = allocated() - before
    check(retriever.fused is not None, f"16 {tag} the kNN shard did not take the fused route")
    zero()
    sync(torch, dev)
    t0 = time.perf_counter()
    s, i = retriever.topk(q, MESH_K)
    sync(torch, dev)
    secs["sharded_topk"] = time.perf_counter() - t0
    out["launches"] = read()
    check(out["launches"]["fused_stage1"] > 0 and out["launches"]["peel_rows"] > 0,
          f"16 {tag} sharded_topk did not launch K1 and K2: {out['launches']}")
    i, s = i.cpu().numpy(), s.cpu().numpy()
    # this rank's block searched alone by FusedRetriever.topk: the ids the
    # merge keeps from the block are, row by row, a prefix of its list
    lo = axis_index(mesh, "model") * block.shape[0]
    own_i = FusedRetriever(block, metric="euclidean", precision="compensated",
                           device=dev).topk(q, MESH_K, exact_scores=True)[1].cpu().numpy()
    own = (i >= lo) & (i < lo + block.shape[0])
    kept = np.take_along_axis(i, np.argsort(~own, axis=1, kind="stable"), 1) - lo
    first = np.arange(MESH_K)[None, :] < own.sum(axis=1)[:, None]
    out["own_block_kept"] = float(own.mean())
    check(bool((kept[first] == own_i[first]).all()),
          f"16 {tag} the ids kept from this rank's block differ from FusedRetriever.topk's "
          "on the block")
    same = i == ref["topk_i"]
    out["topk_ids_equal_share"] = float(same.mean())
    if axis_size(mesh, "model") == 1:  # one shard: FusedRetriever.topk's own search
        check(bool(same.all()), f"16 {tag} sharded_topk ids differ from FusedRetriever.topk's")
    # each shard's windows differ from the whole table's, so with two shards
    # the approximate search may keep other items; an item both keep has
    # the same exact score
    out["topk_max_abs_err"] = float(np.abs(s[same] - ref["topk_s"][same]).max())
    check(out["topk_max_abs_err"] <= 1e-5 * float(np.abs(ref["topk_s"]).max()),
          f"16 {tag} sharded_topk scores of the same ids differ")
    out["recall"] = overlap(i, ref["exact_i"])
    check(out["recall"] >= MESH_RECALL, f"16 {tag} sharded_topk recall {out['recall']}")
    out["block_rows"] = int(block.shape[0])
    got = sharded_lookup(mesh, block, torch.as_tensor(inp["qi"], device=dev))
    check(torch.equal(got, q), f"16 {tag} sharded_lookup differs from indexing")
    del block, retriever, q, s, got

    def timed_ms(fn):
        return cuda_ms(torch, fn, reps, warmup=int(reps > 1))

    mf = mf_configs()[0]
    full = mesh_mf_tables(torch, dev)
    before = allocated()
    shards = [shard_rows(mesh, t) for t in full]
    lo = [axis_index(mesh, "model") * t.shape[0] for t in shards[:2]]
    out["mf_shard_bytes"] = allocated() - before
    del full
    torch.cuda.empty_cache()
    step = make_sharded_mf_step(mesh, loss=mf.loss)
    loss = step(*shards, inp["mf_si"], inp["mf_ai"], inp["mf_y"], tmf_lr(mf))[4]
    worst = 0.0
    for j in (0, 1):
        worst = max(worst, touched_close(torch, shards[j], ref[f"mf_t{j}"], ref[f"mf_idx{j}"],
                                         lo[j]),
                    touched_close(torch, shards[2 + j], ref[f"mf_a{j}"], ref[f"mf_idx{j}"],
                                  lo[j]))
    out["mf_err"] = worst
    out["mf_loss_rel"] = abs(float(loss) - float(ref["mf_loss"])) / abs(float(ref["mf_loss"]))
    check(worst <= MF_RTOL and out["mf_loss_rel"] <= MF_LOSS_RTOL,
          f"16 {tag} sharded MF step: {worst:.3e}, loss {out['mf_loss_rel']:.2e}")
    cols = [torch.as_tensor(inp[k], device=dev) for k in ("mf_si", "mf_ai", "mf_y")]
    out["mf_ms"] = timed_ms(lambda: step(*shards, *cols, tmf_lr(mf)))
    del shards, cols

    full = mesh_sgns_tables(torch, dev, inp["w_in"].shape[0])
    shards = [shard_rows(mesh, t) for t in full]
    del full
    lo = axis_index(mesh, "model") * shards[0].shape[0]
    step = make_sharded_sgns_step(mesh, n_negatives=MESH_SGNS["negatives"])
    B = MESH_SGNS["batch"]
    loss = step(*shards, inp["sgns_c"], inp["sgns_x"], inp["sgns_negs"], MESH_SGNS["lr"])[4]
    out["sgns_err"] = max(touched_close(torch, shards[j], ref[f"sgns_{j}"],
                                        ref[f"sgns_idx{j}"], lo) for j in range(4))
    out["sgns_loss_rel"] = abs(float(loss) - float(ref["sgns_loss"])) / float(ref["sgns_loss"])
    check(out["sgns_err"] <= MF_RTOL and out["sgns_loss_rel"] <= MF_LOSS_RTOL,
          f"16 {tag} sharded SGNS step: {out['sgns_err']:.3e}, loss {out['sgns_loss_rel']:.2e}")
    cols = [torch.as_tensor(inp[k], device=dev) for k in ("sgns_c", "sgns_x", "sgns_negs")]
    out["sgns_ms"] = timed_ms(lambda: step(*shards, *cols, MESH_SGNS["lr"]))
    del shards, cols
    torch.cuda.empty_cache()

    model, x, mask = mesh_tower(torch)
    t0 = time.perf_counter()
    scores = model.predict(x, mask, mesh=mesh, device=dev)
    secs["tower"] = time.perf_counter() - t0
    want = ref["tower"]
    out["tower_bit_equal"] = bool(np.array_equal(scores, want))
    d = np.abs(scores[mask] - want[mask])
    out["tower_max_rel"] = float(d.max() / np.abs(want[mask]).max())
    check(np.array_equal(np.isinf(scores), ~mask)
          and (d <= TOWER_REL * (np.abs(want[mask]) + TOWER_FLOOR)).mean() >= TOWER_SHARE
          and out["tower_max_rel"] <= TOWER_WORST, f"16 {tag} tower scores")
    return out


def mesh_counters():
    """Zero and read K1's and K2's launch counters (16b's ranks)."""
    from otto_tpu_torch.ops import fused_retrieval, row_topk

    def zero():
        fused_retrieval.fused_stage1.launches = row_topk.peel_rows.launches = 0

    def read():
        return {"fused_stage1": fused_retrieval.fused_stage1.launches,
                "peel_rows": row_topk.peel_rows.launches}

    return zero, read


def mesh_rank_main(work: Path) -> int:
    """A 16b, 17b and 18b rank (``python3 chip_smoke.py --mesh-rank DIR``
    under torchrun's environment): gloo on the shared card, the dryrun's
    tiny shapes, then every sharded call at meshes (1, 2) and (2, 1) against
    16a's results, then phase 17b at (2, 1), then phase 18b at (1, 2) and
    the 3-D meshes (1, 2, 1) and (1, 1, 2).  Prints one JSON line."""
    import torch
    import torch.distributed as dist

    from otto_tpu_torch.config import MeshConfig
    from otto_tpu_torch.parallel import (
        dryrun,
        init_distributed,
        make_mesh,
        make_mesh3d,
        mesh_device,
    )

    check(init_distributed("gloo", timeout_s=300), "16b: no rank environment")
    inp = mesh_load(work)
    ref = dict(np.load(work / "ref.npz"))
    res = {}
    for shape in ((1, 2), (2, 1)):
        mesh = make_mesh(MeshConfig(data_parallel=shape[0], model_parallel=shape[1]),
                         device_type="cuda")
        tag = f"{shape[0]}x{shape[1]}"
        res[f"dryrun_{tag}"] = dryrun.run(mesh)
        res[tag] = mesh_run(torch, mesh, inp, ref, mesh_counters(), build=shape == (2, 1),
                            tag=tag, reps=1)
    del inp, ref
    t0 = time.perf_counter()
    res["dp"] = dp_rank(torch, mesh, work)  # phase 17b at mesh (2, 1)
    res["dp"]["s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    zero, read = mesh_counters()
    zero()
    res["mp"] = mp_steps(  # phase 18b at mesh (1, 2), (1, 2, 1) and (1, 1, 2)
        torch, mesh_device(mesh), make_mesh(MeshConfig(data_parallel=1, model_parallel=2),
                                            device_type="cuda"),
        [make_mesh3d(1, 2, 1, device_type="cuda"), make_mesh3d(1, 1, 2, device_type="cuda")],
        "18b", read)
    res["mp"]["s"] = time.perf_counter() - t0
    res["rank"] = dist.get_rank()
    res["device"] = str(mesh_device(mesh))
    dist.destroy_process_group()
    print("16b rank result: " + json.dumps(res), flush=True)
    return 0


def nccl_refusal() -> str:
    """Two NCCL ranks on the one card (``python -m
    otto_tpu_torch.parallel.dryrun``, NCCL by default): they must fail;
    returns NCCL's message."""
    from otto_tpu_torch.parallel.mesh import launch_local

    try:
        launch_local([sys.executable, "-m", "otto_tpu_torch.parallel.dryrun"], 2,
                     timeout_s=60, env={"PYTHONPATH": str(REPO)}, cwd=REPO)
    except RuntimeError as e:
        lines = str(e).splitlines()
        for key in ("uplicate GPU", "ncclInvalidUsage", "NCCL"):
            hit = [ln.strip() for ln in lines if key in ln]
            if hit:
                return hit[0]
        check(False, f"16b: two NCCL ranks failed without NCCL's message: {e}")
    check(False, "16b: two NCCL ranks on one card did not fail")
    return ""


def sharded_paths(torch, dev, bench_train, bench_mats, bench_aids: int, phase7: dict,
                  dp_fold: dict, zero_counters, read_counters) -> dict:
    """Phases 16 and 17 (16a and 17a one NCCL rank in this process, 16b and
    17b two gloo ranks on the same card); returns their numbers and K1/K2's
    launches at world 1 and 2."""
    import os

    from otto_tpu_torch.utils.runtime import device_line

    import torch.distributed as dist

    from otto_tpu_torch.config import MeshConfig
    from otto_tpu_torch.parallel import init_distributed, make_mesh, make_mesh3d
    from otto_tpu_torch.parallel.mesh import launch_local

    shutil.rmtree(MESH_DIR, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        inp = mesh_inputs(torch, dev, bench_train, bench_aids, phase7, MESH_DIR)
        write_s = time.perf_counter() - t0
        ref = mesh_single(torch, dev, inp, phase7, bench_mats)
        t0 = time.perf_counter()
        np.savez(MESH_DIR / "ref.npz", **ref)
        print(f"16 inputs and 16a's single-device results written under "
              f"{MESH_DIR.relative_to(REPO)} in {write_s + time.perf_counter() - t0:.2f} s",
              flush=True)

        env = mesh_env()
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        t0 = time.perf_counter()
        try:
            check(init_distributed("nccl", timeout_s=300), "16a: no process group")
            mesh = make_mesh(MeshConfig(), device_type="cuda")
            loaded = mesh_load(MESH_DIR)
            loaded["w_in"] = phase7["w_in"].cpu().numpy()
            a = mesh_run(torch, mesh, loaded, ref,
                         (zero_counters, lambda: read_counters("sharded_topk at world 1",
                                                               ("fused_stage1", "peel_rows"))),
                         build=True, tag="1x1")
            a["total_s"] = time.perf_counter() - t0
            print(f"16a mesh (1, 1), one rank on {dev}: " + json.dumps(a), flush=True)
            t0 = time.perf_counter()
            dp_a = dp_world1(torch, dev, mesh, dp_fold, MESH_DIR, (zero_counters, read_counters))
            dp_a["s"] = time.perf_counter() - t0
            print(f"17a data-parallel training, one NCCL rank: {dp_a['s']:.2f} s", flush=True)
            del dp_fold
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            zero_counters()
            mp_a = mp_steps(torch, dev, mesh, [make_mesh3d(1, 1, 1, device_type="cuda")], "18a",
                            lambda: read_counters("model-parallel steps (phase 18a)", ()))
            check(not any(mp_a["launches"].values()), "phase 18a launched a hand kernel")
            mp_a["s"] = time.perf_counter() - t0
            print(f"18a model and expert parallelism, one NCCL rank, meshes (1, 1) and "
                  f"(1, 1, 1), {mp_a['s']:.2f} s; each step against the single-device step "
                  f"({device_line(dev)}): " + json.dumps(mp_a), flush=True)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

        t0 = time.perf_counter()
        outs = launch_local([sys.executable, str(REPO / "chip_smoke.py"), "--mesh-rank",
                             str(MESH_DIR)], 2, timeout_s=480, env={"PYTHONPATH": str(REPO)},
                            cwd=REPO)
        b_s = time.perf_counter() - t0
        ranks = [json.loads(o.split("16b rank result: ", 1)[1].splitlines()[0]) for o in outs]
        for r in ranks:
            share = {tag: {key: r[tag][key] / a[key] for key in MESH_TABLE_BYTES}
                     for tag in ("1x2", "2x1")}
            print(f"16b rank {r['rank']} on {r['device']}, its table bytes over 16a's "
                  f"{json.dumps(share)}: " + json.dumps({k: r[k] for k in ("1x2", "2x1")}),
                  flush=True)
            for tag, (lo, hi) in (("1x2", MESH_HALF_BAND), ("2x1", MESH_WHOLE_BAND)):
                for key, x in share[tag].items():
                    check(lo <= x <= hi, f"16b rank {r['rank']} at {tag}: {key} {x:.4f} of "
                          "16a's")
            check(r["1x2"]["block_rows"] == -(-N_AIDS // 2), "16b: the (1, 2) shard's rows")
            print(f"17b rank {r['rank']} at mesh (2, 1): fit_gbdt(mesh=) on the fold, "
                  f"{DP_TREES['17b']} trees, bit-equal to 17a's single-device forest, "
                  f"{r['dp']['fit_launches']} K5 launches, {r['dp']['fit_s']:.3f} s; bytes "
                  f"all-reduced a level {r['dp']['level_bytes']}, a tree "
                  f"{r['dp']['tree_bytes']:.0f}: " + json.dumps(r["dp"]), flush=True)
        for r in ranks:
            check(not any(r["mp"]["launches"].values()), f"18b rank {r['rank']} launched K1 "
                  f"or K2: {r['mp']['launches']}")
            print(f"18b rank {r['rank']} at mesh (1, 2) and the 3-D meshes (1, 2, 1) and "
                  f"(1, 1, 2), {r['mp']['s']:.2f} s; each step within 14a's bars of the "
                  f"single-device step ({device_line(dev)}): " + json.dumps(r["mp"]), flush=True)
        print(f"16b, 17b and 18b, two gloo ranks sharing cuda:0, meshes (1, 2) and (2, 1): "
              f"{b_s:.2f} s (17b {max(r['dp']['s'] for r in ranks):.2f} s, 18b "
              f"{max(r['mp']['s'] for r in ranks):.2f} s of it)", flush=True)
        t0 = time.perf_counter()
        msg = nccl_refusal()
        print(f"16b two NCCL ranks on one card refused ({time.perf_counter() - t0:.2f} s): "
              f"{msg}", flush=True)
    finally:
        shutil.rmtree(MESH_DIR, ignore_errors=True)
    return {"a": a, "b": ranks, "b_s": b_s, "nccl_refusal": msg, "dp_a": dp_a, "mp_a": mp_a}


# ------------------------------------------------------------- phase 17
# Data-parallel training on the card (otto_tpu_torch/parallel/
# data_parallel.py, fit_gbdt(mesh=)).  17a: one NCCL rank in this process
# (16a's group, mesh (1, 1)), each data-parallel call against its
# single-device call, bit for bit; 17b: 16b's two gloo ranks sharing the card
# at mesh (2, 1).  Widths are the full ones: 11a's first clicks fold of the
# refit ([1,857,664 x 55] rows, 256 bins, the refit's GBDTConfig, depth 7),
# 13a's tower at [4,096 x 184 x 55] (configs/ranker.yaml), and
# configs/sequence_gru.yaml over the 1,855,603-aid catalog.
DP_TREES = {"17a": 30, "17b": 20}
DP_ZERO_STEPS = 3
DP_SEQ_CONFIG = REPO / "configs" / "sequence_gru.yaml"
DP_CUTS = ("17: the refit's 150 trees cut to 30 (17a) and 20 (17b); one tower and one "
           "sequence step, and 3 Adam steps of the ZeRO-1 sequence step against the dp step",)
DP_ZERO_ATOL = 1e-5  # 17b: ZeRO-1 against the dp step (tests/test_torch_data_parallel.py)
DP_STATE_BAND = (0.49, 0.51)  # 17b: a rank's ZeRO Adam state over the dp step's


def dp_forest(forest) -> dict:
    return {k: np.asarray(getattr(forest, k)) for k in
            ("feat", "thr", "leaf", "base", "best_iteration", "gain_importance",
             "split_importance")}


def dp_forest_diff(a: dict, b: dict) -> list[str]:
    """The fields in which two forests differ, bit for bit."""
    return [k for k in a if np.asarray(a[k]).shape != np.asarray(b[k]).shape
            or np.asarray(a[k]).tobytes() != np.asarray(b[k]).tobytes()]


def dp_fit(torch, dev, fold_args, val, trees: int, mesh=None) -> dict:
    """One fit of the fold with ``trees`` trees, on one device or over
    ``mesh``: its forest, seconds and K5 launches (the counter zeroed
    before, read after)."""
    from otto_tpu_torch.config import GBDTConfig
    from otto_tpu_torch.models import gbdt
    from otto_tpu_torch.ops import hist

    cfg = GBDTConfig(**{**vars(fold_args[4]), "n_trees": trees})
    hist.node_histograms.launches = 0
    sync(torch, dev)
    t0 = time.perf_counter()
    forest = gbdt.fit_gbdt(*fold_args[:4], cfg, val=val, mesh=mesh,
                           device=None if mesh is not None else dev)
    sync(torch, dev)
    return {"forest": dp_forest(forest), "s": time.perf_counter() - t0,
            "launches": hist.node_histograms.launches}


def dp_tower_inputs(torch):
    """13a's tower (seeded) and a lambdarank batch at [4,096 x 184 x 55]."""
    from otto_tpu_torch.config import RankerConfig
    from otto_tpu_torch.features import RANKER_FEATURES

    cfg = RankerConfig.from_yaml(TOWER_CONFIG)
    F = len(RANKER_FEATURES) + 1
    B, C = MESH_TOWER
    rng = np.random.default_rng(SEED + 17)
    x = (rng.normal(size=(B, C, F)) * 3).astype(np.float32)
    y = (rng.random((B, C)) < 0.1).astype(np.int8)
    m = rng.random((B, C)) < 0.9
    return cfg, seeded_tower(torch, F, cfg.hidden_dims, SEED), (x, y, m)


def dp_seq_inputs(torch, n_batches: int):
    """configs/sequence_gru.yaml over the full catalog: its seeded
    parameters (on the CPU) and ``n_batches`` batches of its shape (left-
    aligned prefixes padded with the PAD id, uniform negatives)."""
    from otto_tpu_torch.models import sequence as sq

    cfg = sq.SequenceModelConfig.from_yaml(DP_SEQ_CONFIG).replace(n_aids=N_AIDS)
    rng = np.random.default_rng(SEED + 18)
    B, L = cfg.batch_size, cfg.max_len
    batches = []
    for _ in range(n_batches):
        mask = np.arange(L)[None, :] < rng.integers(1, L + 1, B)[:, None]
        seq = np.where(mask, rng.integers(0, N_AIDS, (B, L)), N_AIDS).astype(np.int32)
        batches.append((seq, mask, rng.integers(0, N_AIDS, B).astype(np.int32),
                        rng.integers(0, N_AIDS, (B, cfg.n_negatives)).astype(np.int32)))
    return cfg, sq._config_params(cfg, torch.Generator().manual_seed(cfg.seed)), batches


def dp_steps(torch, dev, mesh, tag: str) -> dict:
    """The tower, sequence and ZeRO-1 steps of phase 17 on ``mesh`` (a rank
    of 17a or 17b) against the single-device steps on the same card, which
    this rank runs itself on the whole batch: ``train_step``, and at dp > 1
    for the tower the same objective as the dp step (the mean of the
    blocks' losses).  At one rank (17a) every result must be bit-equal; at
    two (17b) the tower's loss within 13a's bfloat16 bar, the sequence step
    within 14a's limits, ZeRO-1 within DP_ZERO_ATOL of the dp step over
    DP_ZERO_STEPS Adam steps and its Adam state about half the dp step's.
    Returns the numbers."""
    from functools import partial

    from otto_tpu_torch.models import ranker
    from otto_tpu_torch.models import sequence as sq
    from otto_tpu_torch.parallel import (
        make_dp_ranker_step,
        make_dp_sequence_step,
        make_zero_sequence_step,
        zero_init,
    )
    from otto_tpu_torch.parallel.data_parallel import optimizer_state_numel
    from otto_tpu_torch.parallel.mesh import axis_size
    from otto_tpu_torch.utils.runtime import full_f32_matmul

    one = tag == "17a"
    dp = axis_size(mesh, "data")
    out = {}
    cfg, params, batch = dp_tower_inputs(torch)
    xb = [torch.as_tensor(a, device=dev) for a in batch]
    lr = ranker.learning_rate(cfg, 0)

    def blocks_step(tower, opt):
        """The dp step's objective on one device: the mean of the ``data``
        blocks' losses (JAX's pmean of the shards' losses; LambdaRank
        normalises by each block's pair count, so at dp > 1 it differs from
        the whole batch's loss)."""
        per = xb[0].shape[0] // dp
        for group in opt.param_groups:
            group["lr"] = lr
        opt.zero_grad(set_to_none=True)
        with full_f32_matmul():
            loss = sum(ranker.LOSSES[cfg.loss](tower(xb[0][i * per:(i + 1) * per]),
                                               xb[1][i * per:(i + 1) * per],
                                               xb[2][i * per:(i + 1) * per])
                       for i in range(dp)) / dp
            loss.backward()
        opt.step()
        return loss.detach()

    towers, losses, secs = [], [], []
    for route in ("single", "dp"):
        tower = ranker.Tower(params).to(dev)
        opt = ranker.make_optimizer(tower, cfg)
        sync(torch, dev)
        t0 = time.perf_counter()
        if route == "single" and one:
            loss = ranker.train_step(tower, opt, *xb, lr, loss=cfg.loss)
        elif route == "single":
            loss = blocks_step(tower, opt)
        else:
            loss = make_dp_ranker_step(mesh, opt, loss_name=cfg.loss)(tower, *xb, lr=lr)
        sync(torch, dev)
        secs.append(time.perf_counter() - t0)
        towers.append(ranker.tower_params_to_numpy(tower))
        losses.append(float(loss))
    same = all(towers[0][k].tobytes() == towers[1][k].tobytes() for k in towers[0])
    rel = abs(losses[1] - losses[0]) / abs(losses[0])
    out["tower"] = {"bit_equal": same and losses[0] == losses[1], "loss_rel": rel,
                    "param_max_diff": max(float(np.abs(towers[0][k] - towers[1][k]).max())
                                          for k in towers[0]),
                    "single_s": secs[0], "dp_s": secs[1]}
    check(out["tower"]["bit_equal"] if one else rel <= STEP_LOSS_RTOL["bfloat16"],
          f"{tag} dp tower step against train_step: {out['tower']}")
    del xb, towers
    torch.cuda.empty_cache()

    scfg, base, batches = dp_seq_inputs(torch, 1 + DP_ZERO_STEPS)
    kw = dict(loss=scfg.loss, bpr_reg=scfg.bpr_reg)
    dbatches = [[torch.as_tensor(a, device=dev) for a in b] for b in batches]

    def fresh():
        return sq._tree_map(lambda t: t.to(dev, copy=True).requires_grad_(True), base)

    runs = []
    for route in ("single", "dp"):
        p = fresh()
        opt = sq.make_optimizer(p, scfg)
        sync(torch, dev)
        t0 = time.perf_counter()
        if route == "single":
            loss = sq.train_step(p, opt, *dbatches[0], **kw)
        else:
            loss = make_dp_sequence_step(mesh, opt, **kw)(p, *dbatches[0])
        sync(torch, dev)
        runs.append((p, float(loss), time.perf_counter() - t0))
        del opt
    (p1, l1, s1), (p2, l2, s2) = runs
    leaves1, leaves2 = sq.tree_leaves(p1), sq.tree_leaves(p2)
    same = l1 == l2 and all(torch.equal(a, b) for a, b in zip(leaves1, leaves2))
    out["sequence"] = {"bit_equal": same, "loss_rel": abs(l2 - l1) / abs(l1), "single_s": s1,
                       "dp_s": s2, "params": sum(t.numel() for t in leaves1)}
    if one:
        check(same, f"17a dp sequence step differs from train_step: {out['sequence']}")
    else:
        check(out["sequence"]["loss_rel"] <= SEQ_LOSS_RTOL,
              f"17b dp sequence step's loss: {out['sequence']}")
        ref = sq._tree_map(lambda t: t.detach().cpu(), p1)
        for r, t in zip(sq.tree_leaves(ref), leaves1):
            r.grad = t.grad.cpu()
        out["sequence"]["sign_decided"] = seq_step_matches(torch, ref, p2, scfg.learning_rate)
        del ref
    del runs, p1, p2, leaves1, leaves2
    torch.cuda.empty_cache()

    pd, pz = fresh(), fresh()
    adam = partial(torch.optim.Adam, lr=scfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                   fused=True)  # sequence.make_optimizer's
    dopt = adam(sq.tree_leaves(pd))
    state = zero_init(mesh, adam, pz)
    dstep = make_dp_sequence_step(mesh, dopt, **kw)
    zstep = make_zero_sequence_step(mesh, **kw)
    dl, zl, zsecs = [], [], 0.0
    for b in dbatches[1:]:
        dl.append(float(dstep(pd, *b)))
        sync(torch, dev)
        t0 = time.perf_counter()
        zl.append(float(zstep(pz, state, *b)))
        sync(torch, dev)
        zsecs += time.perf_counter() - t0
    diff = max(float((a.detach() - b.detach()).abs().max())
               for a, b in zip(sq.tree_leaves(pd), sq.tree_leaves(pz)))
    ratio = optimizer_state_numel(state.optimizer) / optimizer_state_numel(dopt)
    out["zero"] = {"max_abs_diff": diff, "bit_equal": diff == 0.0 and dl == zl,
                   "loss_diff": max(abs(a - b) for a, b in zip(dl, zl)),
                   "state_over_dp": ratio, "ms_a_step": 1e3 * zsecs / DP_ZERO_STEPS}
    if one:
        check(out["zero"]["bit_equal"], f"17a ZeRO-1 differs from the dp step: {out['zero']}")
    else:
        check(diff <= DP_ZERO_ATOL and out["zero"]["loss_diff"] <= DP_ZERO_ATOL
              and DP_STATE_BAND[0] <= ratio <= DP_STATE_BAND[1],
              f"17b ZeRO-1 against the dp step: {out['zero']}")
    del pd, pz, dopt, state, dbatches, base
    torch.cuda.empty_cache()
    return out


def dp_world1(torch, dev, mesh, fold: dict, work: Path, counters) -> dict:
    """Phase 17a in 16a's NCCL group (mesh (1, 1)): ``fit_gbdt(mesh=)`` of
    the fold at DP_TREES["17a"] trees bit-equal to ``fit_gbdt`` without a
    mesh (features, thresholds, leaves, best iteration, importances), K5
    launched 7 times a tree on both routes, both timed; the single-device
    fit at DP_TREES["17b"] trees, 17b's reference, written under ``work``
    with the fold; then :func:`dp_steps`."""
    zero, read = counters
    args, val = fold["args"], fold["val"]
    depth = args[4].max_depth
    zero()
    runs = {"single": dp_fit(torch, dev, args, val, DP_TREES["17a"]),
            "mesh": dp_fit(torch, dev, args, val, DP_TREES["17a"], mesh=mesh)}
    launches = read("data-parallel fit at world 1 (17a, both routes)", ("node_histograms",))
    for route, r in runs.items():
        check(r["launches"] == depth * DP_TREES["17a"], f"17a {route} fit: {r['launches']} K5 "
              f"launches for {DP_TREES['17a']} trees")
    diff = dp_forest_diff(runs["mesh"]["forest"], runs["single"]["forest"])
    check(not diff, f"17a fit_gbdt(mesh=) differs from fit_gbdt in {diff}")
    ref = dp_fit(torch, dev, args, val, DP_TREES["17b"])["forest"]
    rows, labels, mask, weight = args[:4]
    vb, vl, vm = val
    np.savez(work / "dp_fold.npz", binned=rows.cpu().numpy(), labels=labels, mask=mask,
             weight=weight, vb=vb.cpu().numpy(), vl=vl, vm=vm)
    np.savez(work / "dp_ref.npz", **ref)
    S, C, F = rows.shape
    print(f"17a fit_gbdt over mesh (1, 1) on the first clicks fold [{S} sessions x {C} = "
          f"{S * C} rows x {F}], {DP_TREES['17a']} trees: bit-equal to fit_gbdt (best "
          f"iteration {int(runs['single']['forest']['best_iteration'])}); {depth} K5 "
          f"launches a tree on both routes; single {runs['single']['s']:.3f} s, mesh "
          f"{runs['mesh']['s']:.3f} s", flush=True)
    steps = dp_steps(torch, dev, mesh, "17a")
    print("17a data-parallel steps at mesh (1, 1), bit-equal to the single-device steps: "
          + json.dumps(steps), flush=True)
    return {"fit_single_s": runs["single"]["s"], "fit_mesh_s": runs["mesh"]["s"],
            "fit_launches": runs["mesh"]["launches"], "launches": launches, **steps}


def dp_rank(torch, mesh, work: Path) -> dict:
    """Phase 17b in one of 16b's ranks (mesh (2, 1), gloo on the shared
    card): ``fit_gbdt(mesh=)`` of the fold at DP_TREES["17b"] trees
    bit-equal to 17a's single-device forest, K5 launched 7 times a tree, the
    bytes each level all-reduces; then :func:`dp_steps`."""
    from otto_tpu_torch.parallel import mesh as mesh_mod
    from otto_tpu_torch.parallel import mesh_device

    dev = mesh_device(mesh)
    z = dict(np.load(work / "dp_fold.npz"))
    ref = dict(np.load(work / "dp_ref.npz"))
    cfg = refit_config()
    args = (z["binned"], z["labels"], z["mask"], z["weight"], cfg)
    sizes = []

    def count(real):
        def reduce(m, x, axis):
            sizes.append(x.numel() * x.element_size())
            return real(m, x, axis)
        return reduce

    with wrapped(mesh_mod, "all_reduce_sum", count):
        fit = dp_fit(torch, dev, args, (torch.as_tensor(z["vb"], device=dev), z["vl"], z["vm"]),
                     DP_TREES["17b"], mesh=mesh)
    del z
    diff = dp_forest_diff(fit["forest"], ref)
    check(not diff, f"17b fit_gbdt(mesh=) differs from 17a's single-device forest in {diff}")
    check(fit["launches"] == cfg.max_depth * DP_TREES["17b"],
          f"17b: {fit['launches']} K5 launches for {DP_TREES['17b']} trees")
    check(len(sizes) == fit["launches"], f"17b: {len(sizes)} all-reduces for "
          f"{fit['launches']} levels")
    out = {"fit_s": fit["s"], "fit_launches": fit["launches"],
           "level_bytes": sizes[:cfg.max_depth], "tree_bytes": sum(sizes) / DP_TREES["17b"],
           "device": str(dev)}
    torch.cuda.empty_cache()
    out.update(dp_steps(torch, dev, mesh, "17b"))
    return out


# ------------------------------------------------------------- phase 18
# Model and expert parallelism on the card (otto_tpu_torch/parallel/
# {collectives,model_parallel,expert_parallel}.py): the tensor-, sequence-
# and pipeline-parallel steps and the 3-D step at configs/
# sequence_transformer.yaml's widths, the tensor-parallel step with
# expert-parallel MoE FFNs at configs/sequence_moe.yaml's, and the
# expert-parallel pooled-session recommender on the same table with 4
# experts; all over the full 1,855,603-aid catalog (a 1,855,604 x 64 float32
# table).  18a: 16a's NCCL rank, mesh (1, 1) and (1, 1, 1); 18b: 16b's two
# gloo ranks on the one card, mesh (1, 2) and the 3-D step at (1, 2, 1) and
# (1, 1, 2).  Each family's step against the single-device step on the same
# card and inputs, within 14a's bars; at 18a whether it is bit-equal.
MP_CONFIGS = {"dense": REPO / "configs" / "sequence_transformer.yaml",
              "moe": REPO / "configs" / "sequence_moe.yaml"}
MP_EP_EXPERTS = 4  # the ep recommender: configs/sequence_moe.yaml's experts, hidden 4 x dim
MP_N_MICRO = 2
MP_CUTS = ("18: one step of each family after one warm-up step (the configs train 3 epochs); "
           "the single-device reference the same",
           "paid for elsewhere: 11d's store 24,000 -> 20,000 sessions, 14b's six configs "
           "15,000 -> 10,000 training sessions, 14d's submission 20,000 -> 10,000 sessions "
           "(phase 18 adds ~21 s)")


def mp_inputs(torch, name: str):
    """A family's config, its seeded whole parameter tree (CPU) and one
    batch of the config's shape over the full catalog (left-aligned
    prefixes padded with the PAD id, uniform negatives; ``ep``: the pooled
    recommender's tree and a float mask)."""
    from otto_tpu_torch.models import sequence as sq
    from otto_tpu_torch.parallel.expert_parallel import init_moe_recommender

    cfg = sq.SequenceModelConfig.from_yaml(MP_CONFIGS["moe" if name == "moe" else "dense"]) \
        .replace(n_aids=N_AIDS)
    rng = np.random.default_rng(SEED + 19 + ("dense", "moe", "ep").index(name))
    B, L = cfg.batch_size, cfg.max_len
    mask = np.arange(L)[None, :] < rng.integers(1, L + 1, B)[:, None]
    seq = np.where(mask, rng.integers(0, N_AIDS, (B, L)), N_AIDS).astype(np.int32)
    batch = [seq, mask, rng.integers(0, N_AIDS, B).astype(np.int32),
             rng.integers(0, N_AIDS, (B, cfg.n_negatives)).astype(np.int32)]
    gen = torch.Generator().manual_seed(cfg.seed)
    if name == "ep":
        batch[1] = mask.astype(np.float32)
        return cfg, init_moe_recommender(gen, N_AIDS, cfg.dim, 4 * cfg.dim, MP_EP_EXPERTS), batch
    return cfg, sq._config_params(cfg, gen), batch


def mp_adam(torch, leaves, cfg):
    """sequence.make_optimizer's Adam over a rank's blocks."""
    return torch.optim.Adam(leaves, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            fused=True)


def mp_families(mesh, meshes3, name: str, cfg):
    """(family, its mesh, the tree's re-layout, its layouts, the step) of
    ``name``'s config on ``mesh`` and the 3-D meshes."""
    from otto_tpu_torch.parallel import expert_parallel as ep
    from otto_tpu_torch.parallel import model_parallel as mpm
    from otto_tpu_torch.parallel.mesh import axis_size

    def same(p):
        return p

    if name == "ep":
        cap = -(-2 * cfg.batch_size // MP_EP_EXPERTS)  # capacity factor 2, as _moe_ffn's
        return [("ep_recommender", mesh, same, lambda p: ep.moe_recommender_specs(mesh),
                 lambda o: ep.make_ep_moe_step(mesh, o, capacity=cap))]
    if name == "moe":
        return [("tp_ep_moe", mesh, same, lambda p: mpm.tp_param_specs(mesh, p),
                 lambda o: mpm.make_tp_sequence_step(mesh, o))]
    S = axis_size(mesh, "model")
    fams = [("tp", mesh, same, lambda p: mpm.tp_param_specs(mesh, p),
             lambda o: mpm.make_tp_sequence_step(mesh, o)),
            ("tp_sp", mesh, same, lambda p: mpm.tp_param_specs(mesh, p),
             lambda o: mpm.make_tp_sequence_step(mesh, o, sequence_parallel=True)),
            ("pp", mesh, lambda p: mpm.stack_pipeline_params(p, S),
             lambda p: mpm.pp_param_specs(mesh, p),
             lambda o: mpm.make_pp_sequence_step(mesh, o, n_micro=MP_N_MICRO))]
    for m3 in meshes3:
        _, pp, tp = (int(x) for x in m3.mesh.shape)
        fams.append((f"3d_1x{pp}x{tp}", m3,
                     lambda p, pp=pp: mpm.stack_pipeline_params(p, pp),
                     lambda p, m3=m3: mpm.pp_tp_param_specs(m3, p),
                     lambda o, m3=m3, tp=tp: mpm.make_pp_tp_sequence_step(
                         m3, o, n_micro=MP_N_MICRO, sequence_parallel=tp > 1)))
    return fams


def mp_single(torch, dev, name: str, cfg, base, batch):
    """The single-device step (``sequence.train_step``; for ``ep`` the
    recommender's objective without a mesh), after a warm-up step on a
    copy: the updated tree (its leaves carry the step's gradients), the
    loss and the step's seconds."""
    from otto_tpu_torch.models import sequence as sq
    from otto_tpu_torch.parallel.expert_parallel import moe_recommender_loss
    from otto_tpu_torch.utils.runtime import full_f32_matmul

    cap = -(-2 * cfg.batch_size // MP_EP_EXPERTS)

    def step(p, opt):
        if name != "ep":
            return sq.train_step(p, opt, *batch)
        opt.zero_grad(set_to_none=True)
        with full_f32_matmul():
            value = moe_recommender_loss(p, *batch, capacity=cap)
            value.backward()
        opt.step()
        return value.detach()

    for _ in range(2):  # a warm-up step on a copy, then the measured one
        p = sq._tree_map(lambda t: t.to(dev, copy=True).requires_grad_(True), base)
        opt = mp_adam(torch, sq.tree_leaves(p), cfg)
        sync(torch, dev)
        t0 = time.perf_counter()
        loss = float(step(p, opt))
        sync(torch, dev)
        secs = time.perf_counter() - t0
        del opt
    return p, loss, secs


def mp_steps(torch, dev, mesh, meshes3, tag: str, read_launches) -> dict:
    """Phase 18 on ``mesh`` (a rank of 18a or 18b) and the 3-D meshes: each
    family's step after a warm-up step on a copy, against the single-device
    step this rank runs itself; its ms, the bytes this rank handed to
    collectives in the step, the Adam state it holds; at 18a whether it is
    bit-equal; and ``read_launches()``, the kernels' counters after it.
    Every check raises."""
    from otto_tpu_torch.models import sequence as sq
    from otto_tpu_torch.parallel import collectives as coll
    from otto_tpu_torch.parallel import model_parallel as mpm
    from otto_tpu_torch.parallel.data_parallel import optimizer_state_numel

    out = {}
    for name in ("dense", "moe", "ep"):
        cfg, base, batch = mp_inputs(torch, name)
        dbatch = [torch.as_tensor(a, device=dev) for a in batch]
        ref, ref_loss, ref_s = mp_single(torch, dev, name, cfg, base, dbatch)
        out[f"single_{name}"] = {"ms": 1e3 * ref_s, "loss": ref_loss}
        for fam, on, relay, specs_of, make in mp_families(mesh, meshes3, name, cfg):
            tree = relay(base)
            specs = specs_of(tree)
            for warm in (True, False):
                blocks = mpm.shard_params(on, tree, specs)
                opt = mp_adam(torch, sq.tree_leaves(blocks), cfg)
                step = make(opt)
                sync(torch, dev)
                coll.reset_counts()
                t0 = time.perf_counter()
                loss = float(step(blocks, *dbatch))
                sync(torch, dev)
                secs = time.perf_counter() - t0
                moved = dict(coll.COUNTS)
                if warm:
                    del blocks, opt, step
            whole = mpm.gather_params(on, blocks, specs)
            if "stage_layers" in whole:
                whole = mpm.unstack_pipeline_params(whole)
            rel = abs(loss - ref_loss) / abs(ref_loss)
            same = loss == ref_loss and all(torch.equal(a, b) for a, b in
                                            zip(sq.tree_leaves(ref), sq.tree_leaves(whole)))
            check(rel <= SEQ_LOSS_RTOL, f"{tag} {fam}: loss {loss} against the single "
                  f"device's {ref_loss}")
            flipped = seq_step_matches(torch, ref, whole, cfg.learning_rate, f"{tag} {fam}")
            out[fam] = {"ms": 1e3 * secs, "single_ms": 1e3 * ref_s, "loss": loss,
                        "loss_rel": rel, "bit_equal": same, "sign_decided": flipped,
                        "collective_calls": moved["calls"], "collective_bytes": moved["bytes"],
                        "adam_state_bytes": 4 * optimizer_state_numel(opt),
                        "param_bytes": sum(4 * t.numel() for t in sq.tree_leaves(blocks))}
            del blocks, opt, step, whole
            torch.cuda.empty_cache()
        del ref, base, dbatch
        torch.cuda.empty_cache()
    out["launches"] = read_launches()
    return out


# ------------------------------------------------------------- phase 19
# The oracle-parity tool and the examples on the card.  19a:
# tools/parity_run_torch.py's functions at PARITY_SESSIONS sessions over the
# tool's full 100,000 aids (val fraction 0.12, seed 0): the covisitation
# route's and the uncapped candidates' exact agreement with the oracle held
# to 1.0 (what the JAX package measured at 1,000,000 sessions,
# PARITY_1M.json), the float64 host recency route to PARITY_HOST_F64 (the
# bar of tests/test_oracle_parity.py::test_recency_route_host_f64_exact),
# the device recency route printed with no bar (float32 sums order near-ties
# otherwise: ROADMAP §3).  19b: examples/torch 03, 06 and 07 in this process
# through their main at small sizes; each path's kernels launched, 06's
# serving process's lists equal to this process's.

PARITY_SESSIONS = 100_000
PARITY_AIDS = 100_000
PARITY_HOST_F64 = 0.999
PARITY_CUTS = (f"19a: tools/parity_run_torch.py at {PARITY_SESSIONS:,} sessions (its default "
               f"1,000,000) over its full {PARITY_AIDS:,} aids",
               "19b: examples 03, 06 and 07 at the small sizes of EXAMPLE_RUNS (03 and 06 over "
               "70,000 aids, the least round catalog whose kNN table takes stage 1's fused "
               "route; epochs 1; 03's GBDT at 20 trees and the rows that reach the kernels)")
# 19b: each example's arguments and the kernels its path must launch
EXAMPLE_RUNS = {
    "03": (["--sessions", "4000", "--aids", "70000", "--epochs", "1", "--gbdt-trees", "20",
            "--models", "aid_weight,embedding_knn,two_stage (+sgns),two_stage (gbdt engine)"],
           ("fused_stage1", "peel_rows", "aid_vote", "predict_forest", "bin_rows",
            "node_histograms")),
    "06": (["--sessions", "2000", "--aids", "70000", "--fresh", "256", "--epochs", "1"],
           ("fused_stage1", "peel_rows")),
    "07": (["--sessions", "5000", "--aids", "20000", "--tower-steps", "5",
            "--gbdt-sessions", "500", "--gbdt-trees", "5"],
           ("node_histograms", "bin_rows")),
}


def kernel_counters():
    """``(zero_counters, read_counters)`` over each kernel's launch counter
    (the wrapper and its attribute): ``read_counters(path, expected)``
    prints the counts and fails unless each kernel named in ``expected``
    was launched."""
    from otto_tpu_torch.ops import forest, fused_retrieval, fused_sessions, hist, row_topk

    counters = {"fused_stage1": (fused_retrieval.fused_stage1, "launches"),
                "fused_stage1_deep": (fused_retrieval.fused_stage1, "deep_launches"),
                "fused_stage1_fma": (fused_retrieval.fused_stage1, "fma_launches"),
                "fused_stage1_int8": (fused_retrieval.fused_stage1_int8, "launches"),
                "peel_rows": (row_topk.peel_rows, "launches"),
                "aid_vote": (fused_sessions.aid_vote_aggregate, "launches"),
                "predict_forest": (forest.predict_forest, "launches"),
                "predict_forest_rows": (forest.predict_forest_rows, "launches"),
                "bin_rows": (forest.bin_rows, "launches"),
                "node_histograms": (hist.node_histograms, "launches")}

    def zero_counters():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read_counters(path: str, expected) -> dict:
        launches = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
        print(f"kernel launches in the {path}: {launches}", flush=True)
        for name in expected:
            check(launches[name] > 0, f"{name} was not launched by the {path}")
        return launches

    return zero_counters, read_counters


def parity_on_card(torch, dev) -> dict:
    """Phase 19a: the oracle-parity tool's routes on the card."""
    from otto_tpu_torch import EVENT_TYPES
    from otto_tpu_torch.utils.runtime import device_line, load_file

    pr = load_file(REPO / "tools" / "parity_run_torch.py", "parity_run_torch")
    t0 = time.perf_counter()
    prep = pr.prepare(PARITY_SESSIONS, PARITY_AIDS, 0.12, 0, dev)
    prep_s = time.perf_counter() - t0
    routes = {k: int(len(v)) for k, v in prep["routes"].items()}
    print(f"19a: {prep['store']}; val {prep['split'].val_input.n_sessions} sessions, routes "
          f"{routes}; data and build {prep_s:.2f} s (build {prep['build_s']:.3f} s, "
          f"{device_line(dev)})", flush=True)
    device = pr.heuristic_parity(prep)
    host = pr.heuristic_parity(prep, recency_host_f64=True)
    cand = pr.candidate_parity(prep)
    out = {"routes": routes, "build_s": prep["build_s"], "prep_s": prep_s,
           "heuristic_s": device["framework_s"], "heuristic_host_f64_s": host["framework_s"],
           "oracle_heuristic_s": device["oracle_s"], "candidates_s": cand["framework_s"],
           "oracle_candidates_s": cand["oracle_s"],
           "cap_binding_fraction": cand["cap_binding_fraction"]}
    for t in EVENT_TYPES:
        cov = device[t]["routes"]["covisitation"]["exact"]
        rec = device[t]["routes"].get("recency_weight", {}).get("exact")
        rec_host = host[t]["routes"].get("recency_weight", {}).get("exact")
        out[t] = {"covisit_route_exact": cov, "recency_route_exact_device": rec,
                  "recency_route_exact_host_f64": rec_host, "exact": device[t]["exact"],
                  "candidates_exact": cand[t]["exact"],
                  "candidates_exact_uncapped": cand[t]["exact_uncapped"],
                  "recall": device["recall_framework"][t],
                  "oracle_recall": device["recall_oracle"][t]}
        print(f"19a {t}: covisitation route exact {cov}; recency route exact: device {rec} "
              f"(no bar), host f64 {rec_host}; candidates exact {cand[t]['exact']}, uncapped "
              f"{cand[t]['exact_uncapped']}", flush=True)
        check(cov == 1.0, f"19a {t}: the covisitation route's exact agreement {cov} < 1.0")
        check(cand[t]["exact_uncapped"] == 1.0, f"19a {t}: the uncapped candidates' exact "
              f"agreement {cand[t]['exact_uncapped']} < 1.0")
        check(rec_host is not None and rec_host >= PARITY_HOST_F64,
              f"19a {t}: the host f64 recency route's exact agreement {rec_host}")
    print(f"19a times ({device_line(dev)}): heuristic {device['framework_s']} s (host f64 route "
          f"{host['framework_s']} s), candidates {cand['framework_s']} s; the oracle "
          f"{device['oracle_s']} s and {cand['oracle_s']} s on the host", flush=True)
    return out


def examples_on_card(torch, dev, zero_counters, read_counters) -> dict:
    """Phase 19b: examples 03, 06 and 07 through their main on the card,
    counters zeroed before each and read after."""
    from otto_tpu_torch.utils.runtime import device_line, load_file

    out = {}
    for number, (argv, expected) in EXAMPLE_RUNS.items():
        path = next((REPO / "examples" / "torch").glob(f"{number}_*.py"))
        module = load_file(path, f"otto_example_{path.stem}")
        torch.cuda.empty_cache()
        zero_counters()
        t0 = time.perf_counter()
        got = module.main(["--device", dev.type, *argv])
        sync(torch, dev)
        secs = time.perf_counter() - t0
        launches = read_counters(f"example {path.name}", expected)
        out[number] = {"s": secs, "launches": launches}
        if number == "03":
            out[number]["weighted"] = {k: v["weighted"] for k, v in got["rows"].items()}
        elif number == "06":
            check(got["lists_equal"], "19b: 06's serving process's lists differ from this "
                  "process's")
            out[number].update({k: got[k] for k in ("weighted", "serve_s", "sessions_per_s",
                                                    "process_s", "process_steps",
                                                    "lists_equal")})
        else:
            out[number].update({k: got[k] for k in ("sgns", "cf", "tower", "gbdt", "sequence")})
        print(f"19b example {path.name}: {secs:.2f} s ({device_line(dev)})", flush=True)
    return out


def phase19(torch, dev, zero_counters, read_counters) -> dict:
    """Phase 19: 19a and 19b, with their cut lines and metrics line.
    Returns each path's launches (19a's, and each example's)."""
    from otto_tpu_torch.utils.runtime import device_line

    for cut in PARITY_CUTS:
        print(f"phase 19 cut: {cut}", flush=True)
    zero_counters()
    with phase("19a tools/parity_run_torch.py on the card: the port against the oracle"):
        a = parity_on_card(torch, dev)
    a["launches"] = read_counters("oracle-parity path (19a)", ())
    with phase("19b examples 03, 06 and 07 on the card through their main"):
        b = examples_on_card(torch, dev, zero_counters, read_counters)
    print(f"phase 19 metrics ({device_line(dev)}): " + json.dumps({"19a": a, "19b": b}), flush=True)
    return {"oracle_parity": a["launches"],
            **{f"example_{k}": v["launches"] for k, v in b.items()}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a "
              "CUDA card", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--mesh-rank"]:  # a rank of phase 16b
        return mesh_rank_main(Path(sys.argv[2]))
    from otto_tpu_torch.ops import _kernels
    from otto_tpu_torch.utils.runtime import device_line

    zero_counters, read_counters = kernel_counters()
    dev = torch.device("cuda", 0)
    with phase("1 device and build"):
        print(device_line(dev), flush=True)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"{torch.cuda.get_device_name(0)}", flush=True)
        t0 = time.perf_counter()
        lib_path = _kernels.build()
        _kernels.lib()
        print(f"kernel build+load {time.perf_counter() - t0:.2f} s -> {lib_path.name}",
              flush=True)
        report = lib_path.with_suffix(".ptxas.txt")
        if report.exists():
            for line in report.read_text().splitlines():
                if "entry function" in line or "registers" in line or "spill" in line:
                    print(line.strip(), flush=True)

    with phase("2 kernels vs plain twins"):
        records = compare_kernels(torch, dev, N_AIDS, 256, 2048, QUERY_BATCH,
                                  N_AIDS % QUERY_BATCH)

    workdir = REPO / "tmp" / "chip_smoke"
    workdir.mkdir(parents=True, exist_ok=True)
    try:
        with phase("3 full-width retrieval"):
            model = retrieval(torch, dev, N_AIDS, QUERY_BATCH, 256, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    zero_counters()
    with phase("3b wide-table retrieval (stage 1's deep wgmma route)"):
        retriever, wide_q = wide_retrieval(torch, dev, 1_000_000, 96, 256)
    wide = read_counters("wide-table retrieval", ("fused_stage1_deep", "peel_rows"))
    check(wide["fused_stage1_fma"] == 0 and wide["fused_stage1"] == 0,
          f"the compensated wide table left the deep route: {wide}")
    with phase("3b stage 1's deep route vs its twin and the FMA kernel on the wide table"):
        records.insert(1, wide_stage1_vs_twin(torch, dev, retriever, wide_q))
    del retriever
    with phase("3b stage 1's deep route at the full catalog's shape"):
        records[1]["full_catalog"] = deep_full_catalog(torch, dev, QUERY_BATCH, 294, N_AIDS)
    zero_counters()
    with phase("3b the wide table in float32 (stage 1's FMA kernel)"):
        retriever, _ = wide_retrieval(torch, dev, 1_000_000, 96, 256,
                                      table_dtype=torch.float32)
    wide_f32 = read_counters("float32 wide-table retrieval", ("fused_stage1_fma", "peel_rows"))
    check(wide_f32["fused_stage1_deep"] == 0 and wide_f32["fused_stage1"] == 0,
          f"the float32 wide table left the FMA route: {wide_f32}")
    with phase("3b stage 1's FMA kernel vs its twin on the float32 wide table"):
        records.insert(2, f32_stage1_vs_twin(torch, dev, retriever, wide_q))
    del retriever, wide_q
    torch.cuda.empty_cache()

    for cut in PHASE3C_CUTS:
        print(f"phase 3c cut: {cut}", flush=True)
    with phase("3c-i the int8 stage-1 kernel vs its twin on the full catalog"):
        records.insert(3, int8_stage1_vs_twin(torch, dev, model.w_in, QUERY_BATCH))
    torch.cuda.empty_cache()
    with phase("3c-ii build_neighbor_table(backend='int8') on the full catalog"):
        int8_run = int8_neighbor_table(torch, dev, model.w_in, QUERY_BATCH, zero_counters,
                                       read_counters)
    with phase("3c-iii topk_hybrid and topk_approx on the full catalog"):
        hybrid_run = hybrid_approx(torch, dev, model.w_in, QUERY_BATCH, zero_counters,
                                   read_counters)
    # the FMA kernel's record gains its numbers at topk_hybrid's shape
    next(r for r in records if r["name"] == "fused_stage1_fma")["hybrid_path"] = {
        key: hybrid_run["fma_vs_twin"][key]
        for key in ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
    with phase("3c-iv rescore_survivors on the compensated retriever"):
        survivors_run = survivors_batch(torch, dev, int8_run.pop("retriever"), QUERY_BATCH,
                                        zero_counters, read_counters)
    torch.cuda.empty_cache()
    print("phase 3c metrics: " + json.dumps({
        "int8_table": int8_run, "hybrid_approx": hybrid_run, "rescore_survivors": survivors_run}),
        flush=True)

    zero_counters()
    with phase("4 serving path"):
        knn_table = serve(torch, dev, model, 20_000, 256)
    knn = read_counters("embedding-kNN serving path", ("fused_stage1", "peel_rows", "aid_vote"))
    torch.cuda.empty_cache()

    with phase("5 session vote vs plain twin"):
        vote = compare_vote(torch, dev, 4096, 256, 512)
        vote["err"] = max(vote["err"], compare_vote(torch, dev, 1024, 300, 256, reps=0)["err"])
        b5 = vote["bound"]
        print(f"session vote [4096, 256]: bound {b5[0]:.4f} ms ({b5[1]}): cold "
              f"{100 * b5[0] / vote['ms']:.1f}%, warm {100 * b5[0] / vote['warm_ms']:.1f}% of it",
              flush=True)

    with phase("6 covisitation build vs committed tables"):
        built = covisit_build(torch, dev)
    bench_split, bench_store = built["split"], built["store"]
    bench_mats, bench_aids = built["mats"], built["aids"]
    del built

    zero_counters()
    with phase("7 baselines and covisitation heuristic"):
        path = baselines(torch, dev, 200_000)
    heur = read_counters("baseline and heuristic path", ("aid_vote",))

    with phase("8 session vote at the aid-weight path's shape"):
        on_path = vote_on_path(torch, dev, path["target"], path["aid_weight"])
    # No one PyTorch call returns K3's three per-position quantities
    # (library_ms null).  Its ms is the cold one, over input copies that do
    # not fit in L2.
    s_rows, width = on_path["shape"]
    k3_bound = on_path["bound"]
    records.append({"name": "aid_vote", "route": "cuda",
                    "source": "otto_tpu_torch/csrc/session_kernels.cu",
                    "replaces": "otto_tpu/ops/pallas_sessions.py:30", "launches": 0,
                    "max_abs_err": max(vote["err"], on_path["err"]), "ms": on_path["ms"],
                    "plain_ms": on_path["plain_ms"], "bound_ms": k3_bound[0],
                    "bound_by": k3_bound[1], "library_ms": None})
    print(f"session vote [{s_rows}, {width}]: bound {k3_bound[0]:.4f} ms ({k3_bound[1]}): "
          f"cold {100 * k3_bound[0] / on_path['ms']:.1f}%, warm "
          f"{100 * k3_bound[0] / on_path['warm_ms']:.1f}% of it", flush=True)

    with phase("9 two-stage artifact replay (bench.py::e2e_artifact_bench on the card)"):
        replay = two_stage_replay(torch, dev, bench_split, REPLAY_SESSIONS, 300, zero_counters,
                                  read_counters)
    two_stage = replay["launches"]
    with phase("9 two-stage: card vs CPU twin path on 512 sessions"):
        two_stage_parity(torch, dev, bench_split, replay, 512)
    with phase("9 pre-binned scoring (the forest kernel's uint8 entry)"):
        prebinned = prebinned_path(torch, dev, replay, zero_counters, read_counters)
    with phase("9 forest kernel vs its twins on the path's rows"):
        records.extend(forest_vs_twin(torch, dev, replay))
    check(replay["replay"] == REPLAY_EXPECTED, f"two-stage replay {replay['replay']} differs "
          f"from BENCH_r05.json's {REPLAY_EXPECTED}")
    del replay
    with phase("9 two-stage with an SGNS model on the full catalog (the kNN candidate route)"):
        two_stage_sgns = two_stage_knn(torch, dev, model, path, 2000, zero_counters,
                                       read_counters)
    phase7_store, phase7_report = path["store"], path["covisitation_report"]
    phase7_target = path["target"]
    # phase 16's inputs: phase 3's table, phase 4's neighbor table, phase 7's
    # tables, training and target sessions
    phase16 = {"w_in": model.w_in, "ft": knn_table, "mats": path["mats"],
               "train": path["train"], "target": path["target"]}
    del model, path, knn_table

    workdir = REPO / "tmp" / "chip_smoke_cli"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        with phase("10a the file CLI: raw .jsonl and parquet of phase 7's store"):
            files = cli_files(torch, dev, phase7_store, workdir)
        with phase("10b CLI covisitation validation on the .jsonl"):
            cli_covisitation(torch, dev, files, phase7_report)
        with phase("10c CLI aid_weight submission on the parquet"):
            cli_aid_weight_run = cli_aid_weight(torch, dev, files, phase7_store, workdir,
                                                zero_counters, read_counters)
        with phase("10d CLI two_stage validation from a copy of artifacts/bench_e2e"):
            cli_two_stage_run = cli_two_stage(torch, dev, bench_store, workdir, zero_counters,
                                              read_counters)
        with phase("10e CLI two_stage validation: card vs CPU at 500 sessions"):
            cli_card_vs_cpu(torch, dev, bench_store, workdir)
        with phase("10f python -m otto_tpu_torch.pipelines in a process of its own"):
            cli_subprocess(torch, dev, bench_store, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print("phase 10 metrics: " + json.dumps({
        "parse_events_per_s": files["events_per_s"],
        "submission_rows_per_s": cli_aid_weight_run["rows_per_s"],
        "two_stage_sessions_per_s": cli_two_stage_run["sessions_per_s"],
        "aid_vote_launches": cli_aid_weight_run["launches"]["aid_vote"],
        "predict_forest_rows_launches": cli_two_stage_run["launches"]["predict_forest_rows"]}),
        flush=True)

    with phase("11c the bench refit: run_two_stage_streamed in training mode"):
        refit_run = refit(torch, dev, bench_split, zero_counters, read_counters)
    with phase("11c the committed rankers resumed on the refit's training sessions"):
        resumed_train_report(torch, dev, bench_split)
    bench_train = bench_split.train  # phase 16's sharded build
    del bench_split
    with phase("11a the histogram kernel vs its twin on the refit's first fold"):
        records.append(hist_vs_twin(torch, dev, refit_run["fold"]))
    with phase("11a the binning kernel vs its twin on the refit's clicks features"):
        records.append(bin_rows_vs_twin(torch, dev, refit_run.pop("typed")))
    with phase("11b one tree and short fits, card against the CPU twin"):
        fits_card_vs_cpu(torch, dev, refit_run["fold"])
    dp_fold = refit_run.pop("fold")  # phase 17's fold
    workdir = REPO / "tmp" / "chip_smoke_train"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        with phase("11d the CLI trains, then resumes"):
            cli_train_run = cli_train(torch, dev, bench_store, workdir, zero_counters,
                                      read_counters)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print("phase 11 metrics: " + json.dumps({
        "refit_train_s": refit_run["train_s"], "refit_stream_s": refit_run["stream_s"],
        "refit_trees": refit_run["trees"], "refit_lift": refit_run["lift"]["lift"],
        "refit_ci95": refit_run["lift"]["ci95"],
        "fits_s": refit_run["spent"]["train_gbdt_ranker"],
        "node_histograms_launches": refit_run["launches"]["node_histograms"],
        "bin_rows_launches": refit_run["launches"]["bin_rows"]}), flush=True)

    for cut in SGNS_CUTS:
        print(f"phase 12 cut: {cut}", flush=True)
    with phase("12a the SGNS steps at full width, card against CPU"):
        steps = sgns_steps(torch, dev, phase7_store, N_AIDS)
    with phase("12b the SGNS trainers, one epoch on phase 7's first 100,000 sessions"):
        trainers = sgns_trainers(torch, dev, head_sessions(phase7_store, SGNS_TRAINER_SESSIONS),
                                 N_AIDS)
    torch.cuda.empty_cache()
    with phase("12c a trained table through the kernels (planted clusters)"):
        planted = trained_table(torch, dev, phase7_target, N_AIDS, zero_counters,
                                read_counters)
    del phase7_target
    torch.cuda.empty_cache()
    workdir = REPO / "tmp" / "chip_smoke_sgns"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        with phase("12d the CLI: embedding_knn and doc2vec"):
            cli_s1 = cli_sgns(torch, dev, phase7_store, workdir, N_AIDS, zero_counters,
                              read_counters)
        torch.cuda.empty_cache()
        with phase("12e run_two_stage with sgns_config: trains, then resumes"):
            ts_sgns = two_stage_trains_sgns(torch, dev, bench_store, workdir, TWO_STAGE_SGNS_AIDS,
                                     zero_counters, read_counters)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print("phase 12 metrics: " + json.dumps({
        "steps": steps, "trainers": trainers,
        "planted": {k: planted[k] for k in ("same_cluster", "recall", "table_s", "train_s")},
        "cli_s": {k: v["s"] for k, v in cli_s1.items()},
        "cli_train_s": {k: v["train_s"] for k, v in cli_s1.items()},
        "cli_weighted": {k: v["weighted"] for k, v in cli_s1.items()},
        "two_stage_s": {k: v["s"] for k, v in ts_sgns.items()},
        "two_stage_sgns_s": {k: v["sgns_s"] for k, v in ts_sgns.items()}}), flush=True)

    for cut in TOWER_CUTS:
        print(f"phase 13 cut: {cut}", flush=True)
    with phase("13a the tower at full width, card against CPU"):
        tower_a = tower_full_width(torch, dev)
    torch.cuda.empty_cache()
    workdir = REPO / "tmp" / "chip_smoke_tower"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        with phase("13b run_two_stage trains the tower, resumes, pairs it, streams"):
            tower_b = tower_training(torch, dev, bench_store, workdir, zero_counters,
                                     read_counters)
        with phase("13c the CLI's default ranker: two_stage validation trains, then resumes"):
            tower_c = tower_cli(torch, dev, bench_store, workdir, tower_b)
        with phase("13d tfidf validation on phase 7's .jsonl, card against CPU"):
            tower_d = tfidf_run(torch, dev, phase7_store, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print("phase 13 metrics: " + json.dumps({
        "forward_share": tower_a["forward_share"], "forward_worst": tower_a["forward_worst"],
        "step": tower_a["step"], "step_ms": tower_a["step_ms"],
        "candidates_per_s": tower_a["candidates_per_s"], "bench_ms": tower_a["bench_ms"],
        "bench_bound_ms": tower_a["bound_ms"],
        **{k: tower_b[k] for k in ("trained_s", "resumed_s", "train_s", "steps", "ms_a_step",
                                   "maps", "weighted", "weighted_disjoint", "lift", "pair_s",
                                   "streamed_s", "streamed_lift")},
        "cli_s": tower_c, "tfidf": tower_d}), flush=True)

    from otto_tpu_torch.data.splits import split_by_fraction

    for cut in SEQ_CUTS:
        print(f"phase 14 cut: {cut}", flush=True)
    torch.cuda.empty_cache()
    with phase("14a the sequence encoders and one step at full width, card against CPU"):
        seq_a = seq_card_vs_cpu(torch, dev, phase7_store, N_AIDS)
    workdir = REPO / "tmp" / "chip_smoke_seq"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        seq_store = head_sessions(phase7_store, SEQ_STORE_SESSIONS)
        split14 = split_by_fraction(seq_store)  # the store's split, as the CLI makes it
        with phase(f"14b run_sequence with each config on phase 7's first "
                   f"{SEQ_STORE_SESSIONS:,} sessions"):
            seq_b = seq_runs(torch, dev, split14, workdir, zero_counters, read_counters)
        with phase("14c K1 and K3 on the sequence path's operands"):
            seq_c = seq_kernels_on_path(torch, dev, split14.val_input, seq_b["gru"]["model"],
                                        N_AIDS)
        with phase("14d the CLI: sequence validation in process, submission as a process"):
            seq_d = seq_cli(torch, dev, seq_store, workdir, seq_b, zero_counters,
                            read_counters)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print("phase 14 metrics: " + json.dumps({
        "card_vs_cpu": seq_a,
        "runs": {k: {f: v[f] for f in ("train_sessions", "total_s", "train_s", "steps",
                                       "ms_a_step", "draw_ms",
                                       "host_draw_share", "loss_first_tenth",
                                       "loss_last_tenth", "serve_s", "sessions_per_s",
                                       "weighted", "routes")} for k, v in seq_b.items()},
        "recall_vs_exact": seq_c["recall"], "k1": seq_c["k1"], "k3": seq_c["k3"],
        "cli": seq_d}), flush=True)

    for cut in MF_CUTS:
        print(f"phase 15 cut: {cut}", flush=True)
    torch.cuda.empty_cache()
    zero_counters()
    workdir = REPO / "tmp" / "chip_smoke_mf"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    split7 = split_by_fraction(phase7_store)  # phase 7's split, as the CLI makes it
    try:
        with phase("15a the sparse adagrad step at full table height, card against CPU"):
            mf_a = mf_steps(torch, dev, phase7_store)
        with phase("15b train_mf and train_cf with the published configs on phase 7's split"):
            mf_b = mf_training(torch, dev, split7, workdir)
        with phase("15c train_mf for one epoch at the reference's full table shape"):
            mf_c = mf_full_height(torch, dev, phase7_store)
        with phase("15d the NaN guard, the profiler and the roofline on the card"):
            mf_d = mf_utilities(torch, dev, split7, mf_b.pop("mf_model"), mf_a[0], workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    phase16["store"] = phase7_store
    del phase7_store, split7
    mf_launches = read_counters("MF/CF path (phase 15)", ())
    check(not any(mf_launches.values()), "phase 15 launched a hand kernel")
    print("phase 15 launches none of K1-K5 or K4 bin: its step is torch ops", flush=True)
    print("phase 15 metrics: " + json.dumps({
        "steps": mf_a, **{f"train_{k}": mf_b[k] for k in ("mf", "cf")},
        "save_s": mf_b["save_s"], "full_height": mf_c, "utilities": mf_d}), flush=True)

    for cut in MESH_CUTS:
        print(f"phase 16 cut: {cut}", flush=True)
    for cut in DP_CUTS:
        print(f"phase 17 cut: {cut}", flush=True)
    for cut in MP_CUTS:
        print(f"phase 18 cut: {cut}", flush=True)
    torch.cuda.empty_cache()
    with phase("16-18 sharded serving and tables, data-, model- and expert-parallel training: "
               "16a-18a one NCCL rank, 16b-18b two gloo ranks"):
        mesh16 = sharded_paths(torch, dev, bench_train, bench_mats, bench_aids, phase16,
                               dp_fold, zero_counters, read_counters)
    del phase16, bench_mats, bench_train, dp_fold
    a16, b16 = mesh16["a"], mesh16["b"][0]
    dp_a = mesh16["dp_a"]
    print("phase 16 metrics: " + json.dumps({
        "16a": {k: a16[k] for k in ("secs", "total_s", "launches", "recall", "mf_ms", "sgns_ms",
                                    "mf_err", "sgns_err", "tower_bit_equal", "tower_max_rel",
                                    "scores_bit_equal", *MESH_TABLE_BYTES)},
        "mf_ms_15a": mf_a[0]["ms"], "16b_s": mesh16["b_s"],
        "16b": {tag: {k: b16[tag][k] for k in ("secs", "launches", "recall", "mf_ms",
                                               "sgns_ms", "tower_bit_equal", "block_rows",
                                               "own_block_kept", *MESH_TABLE_BYTES)}
                for tag in ("1x2", "2x1")},
        "nccl_refusal": mesh16["nccl_refusal"]}), flush=True)
    print("phase 17 metrics: " + json.dumps({
        "17a": {k: v for k, v in dp_a.items() if k != "launches"},
        "17b": {f"rank{r['rank']}": r["dp"] for r in mesh16["b"]}}), flush=True)
    print("phase 18 launches none of K1-K5 or K4 bin: its steps are torch ops and "
          "collectives", flush=True)
    print(f"phase 18 metrics ({device_line(dev)}): " + json.dumps({
        "18a": {k: v for k, v in mesh16["mp_a"].items() if k != "launches"},
        "18b": {f"rank{r['rank']}": {k: v for k, v in r["mp"].items() if k != "launches"}
                for r in mesh16["b"]}}), flush=True)

    torch.cuda.empty_cache()
    paths19 = phase19(torch, dev, zero_counters, read_counters)

    # launches: each kernel's count on the path it serves (the FMA route on
    # the wide table, the vote on the baselines' path, whose shape is timed;
    # the forest kernel's float-row entry on the two-stage path, its uint8
    # entry on the pre-binned scoring path, the histogram and binning kernels
    # on the bench refit), plus its launches on the SGNS paths of phase 12
    # (a trained table's neighbor table and serving, the CLI's embedding_knn
    # and doc2vec runs, run_two_stage training SGNS and resuming it);
    # the sharded top-k at world 1 (phase 16a) and the data-parallel fit at
    # world 1 (phase 17a); launches_by_path adds the file CLI's aid_weight
    # and two_stage runs, its training and resumed two_stage runs, each 16b
    # rank's sharded top-k at mesh (1, 2) and each 17b rank's fit at (2, 1);
    # phase 19's oracle-parity path and examples 03, 06 and 07 count as
    # extra paths too
    sgns_paths = {"sgns_trained_table": planted["launches"],
                  "cli_embedding_knn_validation": cli_s1["embedding_knn validation"]["launches"],
                  "cli_doc2vec_validation": cli_s1["doc2vec validation"]["launches"],
                  "cli_embedding_knn_submission": cli_s1["embedding_knn submission"]["launches"],
                  "two_stage_sgns_train": ts_sgns["first"]["launches"],
                  "two_stage_sgns_resumed": ts_sgns["resumed"]["launches"]}
    seq_paths = {f"sequence_{k}": v["launches"] for k, v in seq_b.items()}
    seq_paths["cli_sequence_validation"] = seq_d["launches"]
    # phase 3c's paths: the int8 neighbor table (the int8 kernel's home),
    # topk_hybrid and topk_approx (the FMA kernel on float32 tables, the
    # wgmma kernel on bf16), rescore_survivors (the compensated route)
    paths3c = {"int8_neighbor_table": int8_run["launches"],
               "topk_hybrid": hybrid_run["topk_hybrid"]["launches"],
               "topk_approx": hybrid_run["topk_approx"]["launches"],
               "rescore_survivors": survivors_run["launches"]}
    paths = {"embedding_knn": knn, "wide_table_retrieval": wide,
             "wide_table_retrieval_f32": wide_f32, **paths3c, "baselines": heur,
             "two_stage": two_stage, "prebinned_scoring": prebinned,
             "two_stage_sgns": two_stage_sgns, "cli_aid_weight": cli_aid_weight_run["launches"],
             "cli_two_stage": cli_two_stage_run["launches"], "refit": refit_run["launches"],
             "cli_two_stage_train": cli_train_run["launches"],
             "cli_two_stage_resumed": cli_train_run["resumed"], **sgns_paths,
             **{f"two_stage_tower_{k}": v for k, v in tower_b["launches"].items()},
             **seq_paths, "sharded_topk_world1": a16["launches"],
             "dp_fit_world1": dp_a["launches"], **paths19}
    home = {"fused_stage1": knn, "fused_stage1_deep": wide, "fused_stage1_fma": wide_f32,
            "fused_stage1_int8": int8_run["launches"], "peel_rows": knn, "aid_vote": heur,
            "predict_forest": prebinned, "predict_forest_rows": two_stage,
            "node_histograms": refit_run["launches"], "bin_rows": refit_run["launches"]}
    for rec in records:
        rec["launches"] = home[rec["name"]][rec["name"]] + sum(
            c[rec["name"]] for c in (*sgns_paths.values(), *seq_paths.values(),
                                     a16["launches"], dp_a["launches"], *paths3c.values(),
                                     *paths19.values())
            if c is not home[rec["name"]])
        rec["launches_by_path"] = {p: c[rec["name"]] for p, c in paths.items()}
        if rec["name"] in ("fused_stage1", "peel_rows"):  # each rank of 16b, mesh (1, 2)
            rec["launches_by_path"]["sharded_topk_world2_per_rank"] = \
                b16["1x2"]["launches"][rec["name"]]
        if rec["name"] == "node_histograms":  # each rank of 17b's fit, mesh (2, 1)
            rec["launches_by_path"]["dp_fit_world2_per_rank"] = b16["dp"]["fit_launches"]
    # K1 and K3 at the sequence path's shapes (phase 14c): the compensated
    # dim-64 table's contraction of 198, and the recency route's block kernel
    for rec in records:
        if rec["name"] == "fused_stage1":
            rec["sequence_path"] = seq_c["k1"]
        elif rec["name"] == "aid_vote":
            rec["sequence_path"] = seq_c["k3"]
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
