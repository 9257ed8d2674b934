"""Language-model training (the port of ``repro.train``):

    optimizer.py   AdamW (in-place update), int8 compression,
                   compressed_psum, global-norm clipping
    data.py        TokenStream, ProbabilisticSampler (the PGF engine)
    checkpoint.py  atomic, manifest-ed, verified checkpoints
    trainer.py     make_train_step (one rank, or sharded on a mesh),
                   Trainer, run_with_failures
    elastic.py     reshard onto another mesh, degrade_mesh, scale_batch
"""
from . import checkpoint, data, elastic, optimizer, trainer

__all__ = ["checkpoint", "data", "elastic", "optimizer", "trainer"]
