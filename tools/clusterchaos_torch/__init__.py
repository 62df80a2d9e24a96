"""clusterchaos over the PyTorch port: cluster-scale composition of
faultline + crashpoint with a consistency verdict.

The port's copy of ``tools/clusterchaos``: the same 13 scenarios, seeds,
event schedules, invariants and probes, over three ``weaviate_tpu_torch``
``ClusterNode``s. It imports nothing of the JAX package or of
``tools/clusterchaos``. Every entry takes ``device`` (default
``"cuda"``: each node's stores on the card, the subprocess node's too;
without CUDA only ``"cpu"`` runs, as the tests do).

Runs a seeded mixed put/delete/read workload at mixed consistency
levels against a REAL 3-node replicated cluster while partitions,
link flaps and node kills fire, then checks — post-heal — that the
consistency-level promises actually held: QUORUM/ALL-acked writes
survive and read back at ALL, the converged value per uuid is an
allowed (acked-or-ambiguous, digest_rank-ordered) one, acked deletes
never resurrect through hashbeat, ambiguous ops land identically on
every replica, orphaned 2PC prepares expire instead of committing
late, and all replica hashtrees reach root equality within a bounded
number of hashbeat rounds.

``python -m tools.clusterchaos_torch --device cpu`` runs the deterministic
scenario matrix; any randomized sweep round replays bit-for-bit from its
seed.
"""

from tools.clusterchaos_torch.checker import check_run
from tools.clusterchaos_torch.harness import (
    SCENARIOS,
    run_matrix,
    run_scenario,
    run_sweep,
    sweep_spec,
)

__all__ = ["SCENARIOS", "check_run", "run_matrix", "run_scenario",
           "run_sweep", "sweep_spec"]
