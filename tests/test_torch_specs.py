"""The port's shape specs (``configs.shapes.input_specs``,
``launch.steps.state_specs``, ``launch.dryrun.with_depth``) against the JAX
package's, and the dry run's per-device argument bytes against the
reference's specs.

Both packages describe the same cells: every leaf's tree path, shape and
dtype must be the reference's, where the port holds meta tensors and the
reference ``ShapeDtypeStruct``s. The reference's
placement rules wrap each spec in a ``NamedSharding``, which needs real
devices; a stand-in that returns the spec takes its place, as in
``test_torch_placement.py``.
"""
import dataclasses
import math
import os
import types

import jax
import numpy as np
import pytest
import torch

import repro.dist.sharding as JSH
from repro.configs import get_arch as jax_get_arch
from repro.configs.shapes import input_specs as jax_input_specs
from repro.launch.steps import adapt_config as jax_adapt
from repro.launch.steps import state_specs as jax_state_specs
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.configs.shapes import input_specs
from repro_torch.launch import dryrun as D
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.tree import leaves, leaves_with_paths

_flags = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as JD  # noqa: E402  (it sets XLA_FLAGS)
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags


def _dtype(x) -> str:
    if isinstance(x, torch.dtype):
        return str(x).replace("torch.", "")
    return np.dtype(x).name


def _ref_leaves(tree) -> dict:
    """{path: (shape, dtype)} of a reference tree."""
    return {jax.tree_util.keystr(path): (tuple(leaf.shape),
                                         _dtype(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree) -> dict:
    out = {}
    for path, leaf in leaves_with_paths(tree):
        assert isinstance(leaf, torch.Tensor) and leaf.device.type == "meta", \
            (path, leaf)
        out[path] = (tuple(leaf.shape), _dtype(leaf.dtype))
    return out


def _cells(arch_id):
    return [(shape, TS.adapt_config(get_arch(arch_id), shape),
             jax_adapt(jax_get_arch(arch_id), shape))
            for shape in get_arch(arch_id).shapes]


def want_kind(arch, shape, cfg):
    return input_specs(arch, shape, cfg)["kind"]


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_input_specs_equal_reference(arch_id):
    """Each of the arch's cells (and an LM's decode cells with the int8
    cache): the same keys, kind and metadata, and every input leaf's path,
    shape and dtype, as meta tensors."""
    arch, jarch = get_arch(arch_id), jax_get_arch(arch_id)
    for shape, cfg, jcfg in _cells(arch_id):
        variants = [(cfg, jcfg)]
        if want_kind(arch, shape, cfg) == "decode":
            variants.append((dataclasses.replace(cfg, kv_quant=True),
                             dataclasses.replace(jcfg, kv_quant=True)))
        for c, jc in variants:
            got, want = input_specs(arch, shape, c), jax_input_specs(
                jarch, shape, jc)
            assert set(got) == set(want), shape
            for key in set(want) - {"inputs"}:
                assert got[key] == want[key], (shape, key)
            assert _port_leaves(got["inputs"]) == _ref_leaves(
                want["inputs"]), shape


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_state_specs_equal_reference(arch_id):
    """The train state of the arch's first cell: params, AdamW moments
    (float32) and step (int32), leaf for leaf, all on the meta device."""
    arch, jarch = get_arch(arch_id), jax_get_arch(arch_id)
    shape, cfg, jcfg = _cells(arch_id)[0]
    got = TS.state_specs(arch, shape, cfg)
    want = jax_state_specs(jarch, shape, jcfg)
    assert set(got) == {"params", "opt"} and set(got["opt"]) == {"m", "v",
                                                                 "step"}
    assert _port_leaves(got) == _ref_leaves(want)
    assert got["opt"]["step"].dtype == torch.int32
    assert all(t.dtype == torch.float32 for t in leaves(got["opt"]["m"]))


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_with_depth_equals_reference(arch_id):
    arch, jarch = get_arch(arch_id), jax_get_arch(arch_id)
    for shape, cfg, jcfg in _cells(arch_id):
        for depth in (None, 1, 2):
            got, full = D.with_depth(arch, cfg, depth)
            want, jfull = JD.with_depth(jarch, jcfg, depth)
            assert full == jfull, (shape, depth)
            for f in dataclasses.fields(want):
                a, b = getattr(got, f.name), getattr(want, f.name)
                if isinstance(a, torch.dtype):
                    assert _dtype(a) == _dtype(b), f.name
                elif dataclasses.is_dataclass(a):
                    assert dataclasses.asdict(a) == dataclasses.asdict(b)
                else:
                    assert a == b, (shape, depth, f.name)


def _local_bytes(leaf, spec, sizes) -> int:
    n = math.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize
    for entry in tuple(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        n //= math.prod(sizes[a] for a in axes)
    return n


def _ref_argument_bytes(arch_id, shape, sizes, variant="tp") -> int:
    """One device's bytes of the reference's state and inputs of a cell
    under the reference's specs on a mesh of ``sizes``."""
    jarch = jax_get_arch(arch_id)
    jcfg = jax_adapt(jarch, shape)
    spec = jax_input_specs(jarch, shape, jcfg)
    mesh = types.SimpleNamespace(axis_names=tuple(sizes), shape=sizes)
    st = jax_state_specs(jarch, shape, jcfg)
    p_sh = JSH.param_shardings(jarch.family, jcfg, mesh, st["params"],
                               variant)
    in_sh = JSH.input_shardings(jarch.family, jcfg, mesh, spec, variant)
    if spec["kind"] in D.TRAIN_KINDS:
        trees = (st["params"], st["opt"], spec["inputs"])
        # the reference's opt_shardings reads a NamedSharding's mesh
        specs = (p_sh, {"m": p_sh, "v": p_sh,
                        "step": jax.sharding.PartitionSpec()}, in_sh)
    else:
        trees = (st["params"], spec["inputs"])
        specs = (p_sh, in_sh)
    total = 0
    for tree, sh in zip(trees, specs):
        flat = jax.tree_util.tree_leaves(tree)
        flat_sh = jax.tree_util.tree_leaves(
            sh, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert len(flat) == len(flat_sh)
        total += sum(_local_bytes(a, s, sizes)
                     for a, s in zip(flat, flat_sh))
    return total


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_argument_bytes_on_16x16_equal_reference(arch_id, monkeypatch):
    """The dry run's per-device argument bytes of every full-size cell of
    the arch on a fake 16 x 16 world equal the sum of the local shard
    bytes of the reference's ``state_specs`` / ``input_specs`` leaves
    under the reference's specs (a train cell: params, moments, step and
    batch; a serve cell: params and inputs, decode's cache length an
    int32)."""
    monkeypatch.setattr(JSH, "NamedSharding", lambda mesh, spec: spec)
    sizes = {"data": 16, "model": 16}
    with fake_world(256):
        mesh = make_mesh(16, 16, device_type="cpu")
        for shape in get_arch(arch_id).shapes:
            _, args = D.lower_cell(arch_id, shape, mesh, device="cpu")
            assert D.argument_bytes(args) == _ref_argument_bytes(
                arch_id, shape, sizes), shape
