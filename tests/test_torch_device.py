"""The port's constructors and entry points run on the card unless the caller
names another device: ``device=None`` resolves to ``cuda`` and raises where
there is none.  Whether a card is present is decided inside each test (here
by patching ``torch.cuda.is_available``), never at import."""

import numpy as np
import pytest
import torch

import scasml_gp_torch as port
from scasml_gp_torch.gp.state import GPState, load_state, save_state
from scasml_gp_torch.harness import runner
from scasml_gp_torch.utils.device import resolve_device

torch.set_num_threads(2)

EQ = port.GradDependentNonlinear(n_input=4)
CONSTRUCTORS = {
    "GPGradDependentNonlinear": lambda **kw: port.GPGradDependentNonlinear(EQ, **kw),
    "GPSineNonlinear": lambda **kw: port.GPSineNonlinear(port.SineNonlinear(n_input=4), **kw),
    "GPHJBColeHopf": lambda **kw: port.GPHJBColeHopf(port.HJB(n_input=4), **kw),
    "GPAllenCahnSemigroup": lambda **kw: port.GPAllenCahnSemigroup(
        port.AllenCahn(n_input=4), **kw),
    "MLP": lambda **kw: port.MLP(EQ, **kw),
    "MLPFullHistory": lambda **kw: port.MLPFullHistory(EQ, **kw),
}


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_constructor_without_a_device_raises_where_there_is_no_card(no_card, name):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CONSTRUCTORS[name]()
    assert CONSTRUCTORS[name](device="cpu").device == torch.device("cpu")


def test_load_state_defaults_to_the_card(no_card, tmp_path):
    z = np.zeros((2, 4), np.float32)
    state = GPState(*(torch.from_numpy(a) for a in (
        z, z, np.zeros(10, np.float32), np.zeros(6, np.float32),
        np.ones(3, np.float32), np.zeros(2, np.float32))))
    path = str(tmp_path / "state.npz")
    save_state(path, state)
    with pytest.raises(RuntimeError):
        load_state(path)
    assert load_state(path, device="cpu").x_dom.device == torch.device("cpu")


def test_resolve_device_is_the_runners(monkeypatch):
    assert runner.resolve_device is resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")


def test_samplers_default_to_the_generators_device():
    gen = torch.Generator().manual_seed(0)
    x_dom, x_bdy = EQ.generate_data(5, 3, gen)
    assert x_dom.device == x_bdy.device == torch.device("cpu")
    assert x_dom.shape == (5, 4) and x_bdy.shape == (3, 4)
    geom = EQ.geometry()
    for sample in (geom.sample_domain, geom.sample_terminal, geom.sample_boundary):
        assert sample(gen, 4).device == gen.device
    # the same draws as naming the device
    a = geom.sample_boundary(torch.Generator().manual_seed(1), 6)
    b = geom.sample_boundary(torch.Generator().manual_seed(1), 6, device="cpu")
    assert torch.equal(a, b)
