"""Carry a fabric simulator's state across from numpy arrays.

:func:`message_from_numpy` takes a message as a mapping of its field names
(``opcode``, ``dest``, ``value``, ``next_opcode``, ``next_dest``) to arrays —
for instance a JAX ``repro.core.isa.Message``, each field through
``np.asarray`` — and :func:`fabric_from_numpy` a whole fabric state the same
way (``values``, ``next_opcode``, ``next_dest``, ``conflicts``, and the
``right`` / ``down`` wires as message mappings).  They return the port's
:class:`~repro_torch.core.isa.Message` / :class:`~repro_torch.core.fabric.Fabric`
on ``device`` with the same bits, so both simulators can be stepped from
one state.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.fabric import Fabric
from repro_torch.core.isa import Message
from repro_torch.kernels.common import resolve_device

__all__ = ["message_from_numpy", "fabric_from_numpy"]

_DTYPES = {"value": torch.float32, "values": torch.float32}


def _tensor(name: str, a, dev: torch.device) -> torch.Tensor:
    want = _DTYPES.get(name, torch.int32)
    # np.asarray of a JAX array is read-only: copy before from_numpy
    t = torch.from_numpy(np.array(a, copy=True))
    if t.dtype != want:
        raise ValueError(f"{name} is {t.dtype}, the simulator keeps {want}")
    return t.to(dev)


def message_from_numpy(arrays: Mapping, *,
                       device: str | torch.device | None = None) -> Message:
    dev = resolve_device(device)
    return Message(*(_tensor(f.name, arrays[f.name], dev)
                     for f in dataclasses.fields(Message)))


def fabric_from_numpy(arrays: Mapping, *,
                      device: str | torch.device | None = None) -> Fabric:
    dev = resolve_device(device)
    return Fabric(
        values=_tensor("values", arrays["values"], dev),
        next_opcode=_tensor("next_opcode", arrays["next_opcode"], dev),
        next_dest=_tensor("next_dest", arrays["next_dest"], dev),
        right=message_from_numpy(arrays["right"], device=dev),
        down=message_from_numpy(arrays["down"], device=dev),
        conflicts=_tensor("conflicts", arrays["conflicts"], dev))
