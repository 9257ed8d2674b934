"""Language-model training (the port of ``repro.train``):

    optimizer.py   AdamW (in-place update), int8 compression,
                   compressed_psum, global-norm clipping
    data.py        TokenStream, ProbabilisticSampler (the PGF engine)
    checkpoint.py  atomic, manifest-ed, verified checkpoints
    trainer.py     make_train_step, Trainer, run_with_failures

The reference's ``elastic.py`` (resharding onto a new mesh) waits for the
LM mesh (ROADMAP Queue 1 item 6c).
"""
from . import checkpoint, data, optimizer, trainer

__all__ = ["checkpoint", "data", "optimizer", "trainer"]
