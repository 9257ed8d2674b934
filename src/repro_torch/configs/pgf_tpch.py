"""The paper's own workload as an 11th dry-run cell: the distributed
PGF aggregate-query step (``db.distributed.make_query_step``).

Not a ModelConfig — a query-step config.  `input_specs` mirror the LM
cells: tuple columns sharded over (pod, data), frequency grid over model.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class QueryConfig:
    name: str = "pgf_tpch"
    n_tuples: int = 1 << 28          # 268M probabilistic tuples (per step)
    max_groups: int = 4096
    num_freq: int = 1 << 16          # exact-CF distribution capacity
    orders: int = 8


CONFIG = QueryConfig()


def reduced() -> QueryConfig:
    return QueryConfig(name="pgf_tpch_smoke", n_tuples=4096, max_groups=64,
                       num_freq=256, orders=8)
