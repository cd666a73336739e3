"""Rank-side code of the DCN trainer tests (imports no JAX): one
process of a two-process hybrid run, whose local mesh is the spawned
group (or one rank when ``group`` is None)."""

import numpy as np
import torch

from akka_allreduce_tpu_torch.models.train import (TrainConfig,
                                                   make_train_state)
from akka_allreduce_tpu_torch.models.transformer import TransformerConfig
from akka_allreduce_tpu_torch.ops.bucketing import tree_to_vector
from akka_allreduce_tpu_torch.protocol.kv import StoreKv
from akka_allreduce_tpu_torch.runtime.dcn_train import DcnDeadlineTrainer

CFG = TrainConfig(model=TransformerConfig(vocab_size=61, d_model=32,
                                          n_heads=2, n_layers=1, d_ff=64,
                                          max_seq=8),
                  bucket_elems=128, learning_rate=1e-2)
BATCHES = [np.random.default_rng(i).integers(0, 61, size=(4, 8),
                                             dtype=np.int32)
           for i in range(3)]


def train_process(group, pid: int, address: tuple, batches: list):
    """Process ``pid`` of two: rows ``[2 pid, 2 pid + 2)`` of each batch,
    split over the local ranks; returns (losses, the final weights)."""
    state = make_train_state(CFG, generator=torch.Generator().manual_seed(0))
    local = 1 if group is None else group.world
    li = 0 if group is None else group.rank
    lead = li == 0
    tr = DcnDeadlineTrainer(CFG, group, deadline_s=60.0,
                            client=StoreKv.connect(*address) if lead
                            else None,
                            rank=pid, num_processes=2, retain_rounds=16,
                            hb_interval_s=0.1, hb_timeout_s=0.0,
                            check_every=1)
    per = 2 // local
    losses = []
    try:
        for b in batches:
            rows = b[2 * pid + li * per:2 * pid + (li + 1) * per]
            rep = tr.run_round(state, torch.from_numpy(rows.copy()))
            losses.append(rep.loss)
    finally:
        tr.close()
    return losses, tree_to_vector(state.params).detach().numpy()
