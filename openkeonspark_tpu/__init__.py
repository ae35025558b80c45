"""openkeonspark_tpu — knowledge-graph embedding framework in JAX.

A ground-up JAX/XLA/Pallas re-architecture of the capability surface of
OpenKEonSpark (translational KG embedding training on Spark + TF parameter
servers; see SURVEY.md): TransE/TransH/TransR/TransD, exact filtered
Bernoulli corrupt-head/tail negative sampling, margin-ranking training,
raw/filtered link-prediction evaluation (MR/MRR/Hits@1/3/10), triple
classification with per-relation threshold fitting, top-k prediction APIs,
checkpoint/resume, incremental batch training, and multi-host scaling via
`jax.sharding.Mesh` with row-sharded embedding tables.
"""

__version__ = "0.1.0"

from openkeonspark_tpu.config import Config  # noqa: F401

# reference-style imperative facade (drop-in for the reference's
# `from config import Config` / `from models import TransE` pattern):
#   from openkeonspark_tpu import compat
#   con = compat.Config(); con.set_in_path(...); ...
from openkeonspark_tpu import compat  # noqa: F401
