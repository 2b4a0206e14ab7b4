"""Card-only: chip_smoke.py's phase 3p at 2 layers (`parallel_paths`):
p1, a world of 1 on NCCL in this process (engine B's request through
sharded_detect_core bit-equal to predict_batch with its launches, 3
ShardedTrainer steps against the replay); p2, 2 gloo ranks on cuda:0 (the
tower split by heads against the single-process forward, exact
launches); p3, 4 gloo ranks on cuda:0, mesh (2, 2) (3 split trainer steps
against the replay, engine B's request of 13 over the data axis). Marked
`gpu`; skips inside its body when no card is visible. JAX-free:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu_parallel.py
"""

import pytest
import torch


@pytest.mark.gpu
def test_parallel_paths_on_card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke as cs
    from tpudf_torch.ops import _build
    _build.load()
    monkeypatch.setattr(cs, "PAR_LAYERS", 2)
    card = cs.card_line()
    state = cs.parallel_paths(torch.device("cuda", 0), card, str(tmp_path))
    cs.parallel_timings(state, card)
