"""The port's public surface against the reference's frozen one
(``tests/test_public_api.py``): every facade name resolves in
``repro_torch`` and is defined in the port, ``repro_torch.__all__`` stays
sorted, ``repro_torch.fl`` and ``repro_torch.launch`` export every name of
the reference's ``fl`` and ``launch``, and importing the port emits no
DeprecationWarning."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
from test_public_api import FACADE, FL_ALL

import repro_torch
import repro_torch.fl
import repro_torch.launch
from repro import launch as ref_launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", FACADE)
def test_facade_names_resolve_in_the_port(name):
    assert name in repro_torch.__all__
    obj = getattr(repro_torch, name)
    assert obj.__module__.startswith("repro_torch.")


def test_port_all_is_sorted_and_holds_the_facade():
    assert sorted(repro_torch.__all__) == list(repro_torch.__all__)
    assert set(FACADE) <= set(repro_torch.__all__)
    # beyond the facade: the port's two solver entry points
    assert set(repro_torch.__all__) - set(FACADE) == {"solve_schedule_dp_batch", "solve_schedule_dp_torch"}


def test_fl_exports_every_reference_name():
    assert FL_ALL <= set(repro_torch.fl.__all__)
    for name in repro_torch.fl.__all__:
        assert getattr(repro_torch.fl, name).__module__.startswith("repro_torch.")


def test_launch_exports_every_reference_name():
    """The mesh context and sharding names (``set_mesh``, ``shard`` ...)
    beside the step builders, which load on first use."""
    assert set(ref_launch.__all__) <= set(repro_torch.launch.__all__)
    for name in repro_torch.launch.__all__:
        assert getattr(repro_torch.launch, name).__module__.startswith("repro_torch.launch.")


def test_import_emits_no_deprecation_warning():
    proc = subprocess.run(
        [sys.executable, "-W", "error::DeprecationWarning", "-c",
         "import repro_torch, repro_torch.core, repro_torch.fl, repro_torch.serve, repro_torch.launch.train"],
        capture_output=True, text=True, timeout=240, env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
