"""The port alone reproduces the reference's pinned trajectories
(``tests/golden_engine.json``): the small 2-model CNN world, ServerConfig
(local_epochs=2, seed=1), params drawn by the port's own threefry from the
seed, 3 rounds, at the golden test's own tolerance (rtol 2e-3, atol 1e-3,
``tests/test_methods.py``)."""
import json
import os

import numpy as np
import pytest

from repro_torch.core.engine import RoundEngine, ServerConfig
from repro_torch.fl.experiments import build_setting

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_engine.json")


@pytest.mark.parametrize("method", ["lvr", "stalevre"])
def test_port_reproduces_golden_metrics(method):
    golden = json.load(open(GOLDEN))[method]
    tasks, B, avail = build_setting(n_models=2, n_clients=16, seed=0,
                                    small=True)
    eng = RoundEngine(tasks, B, avail,
                      ServerConfig(method=method, local_epochs=2, seed=1),
                      device="cpu")
    state = eng.init_state()
    for want in golden:
        state, mets = eng.round_step(state)
        for key, v in want.items():
            if key == "round":
                continue
            name, s = key.split("/")
            np.testing.assert_allclose(float(mets[name][int(s)]), v,
                                       rtol=2e-3, atol=1e-3,
                                       err_msg=f"{method} round "
                                               f"{want['round']} {key}")
