"""Parity guard: the port (parsec_tpu_torch) has a counterpart of every
public name, native binding and knob of the JAX package (parsec_tpu).

The files are parsed, never imported (AST and regular expressions
only), so the guard needs neither a card nor JAX.  Three checks, each
with its allowlist and a reason for every entry:
  - every public top-level name, class method and package export of
    each parsec_tpu module exists in its port counterpart (one case a
    module);
  - every ptc_* symbol of parsec_tpu/_native.py's `_sigs` is bound in
    the port's `_sigs` with the same signature;
  - every knob that parsec_tpu/utils/config.py registers is registered
    by the port's, with the same default and type, or is one of the
    port's comm/topology.COMM_KNOBS constants.
A later change to either package that opens a gap fails here; an
allowlist entry that no longer names a gap fails too."""
import ast
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "parsec_tpu")
PORT = os.path.join(ROOT, "parsec_tpu_torch")

# reference module -> port module, where the file name differs
MODULE_MAP = {
    "device/tpu.py": "device/cuda.py",  # the device module of the card
}

# reference modules the port has no counterpart of
NO_COUNTERPART = {
    "utils/jaxcompat.py": "one shim over jax's shard_map moves (its "
                          "location, check_rep/check_vma); the port "
                          "imports no JAX",
}

# a name component renamed in the port (applied to every dotted part of
# a reference name before it is looked up in the port)
RENAMES = {
    "TpuDevice": ("CudaDevice", "the device module's class is named for "
                  "the card it drives"),
    "insert_tpu_task": ("insert_cuda_task", "DTD device tasks are "
                        "inserted for the CudaDevice"),
    "DEV_TPU": ("DEV_CUDA", "the package exports the native accelerator "
                "slot under the card's name; _native keeps DEV_TPU as its "
                "alias"),
}

# (reference module, name) the port leaves out, as JAX internals.  The
# check holds public names; the private entries record the JAX-side
# wrappers that have no counterpart by design (each Pallas kernel is a
# CUDA source under parsec_tpu_torch/kernels/ with its own wrapper)
NAME_ALLOW = {
    ("device/tpu.py", "grouped_stack"):
        "a wave's tiles as one jnp.take over their source stacks, padded "
        "to an XLA shape bucket; the port's manager gathers a wave's "
        "lanes in CudaDevice._lanes_of (a slice or index_select of one "
        "cached stack, else a new stack), unpadded",
    ("device/tpu.py", "TpuDevice.warm"):
        "XLA's ahead-of-time compile of a jitted chore; torch chores need "
        "none and the CUDA kernels build at first use (kernels.build_all)",
    ("device/tpu.py", "_get_jitted"):
        "the cache of jax.jit-wrapped chores",
    ("ops/rms_norm.py", "_rms_fwd_pallas"):
        "the pl.pallas_call wrapper of _rms_kernel; the port's is "
        "ops/rms_norm.rms_norm_cuda over kernels/rms_norm.cu",
    ("ops/flash_attention.py", "_flash_fwd"):
        "the pl.pallas_call wrapper of _fa_kernel; the port's is "
        "ops/flash_attention.flash_attention_cuda over "
        "kernels/flash_attention.cu",
}

# knobs the reference registers and the port does not
KNOB_ALLOW = {
    "device.tpu_enabled": "registered by the reference and read nowhere "
                          "in it; the port has no TPU module to enable",
}


def _ref_modules():
    out = []
    for d, _, files in os.walk(REF):
        out += [os.path.relpath(os.path.join(d, f), REF).replace(os.sep, "/")
                for f in files if f.endswith(".py")]
    return sorted(out)


def _parse(path):
    with open(path) as f:
        return ast.parse(f.read(), filename=path)


def _names(path):
    """Top-level defs, classes and their methods (Class.method),
    assigned names, `__all__` entries and, in a package's __init__, the
    names it re-exports from its own modules."""
    out = set()
    is_pkg = path.endswith("__init__.py")
    for n in _parse(path).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(n.name)
        elif isinstance(n, ast.ClassDef):
            out.add(n.name)
            out.update(f"{n.name}.{m.name}" for m in n.body
                       if isinstance(m, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)))
        elif isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
                    if t.id == "__all__" and isinstance(
                            n.value, (ast.List, ast.Tuple)):
                        out.update(e.value for e in n.value.elts)
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
        elif isinstance(n, ast.ImportFrom) and n.level > 0 and is_pkg:
            out.update(a.asname or a.name for a in n.names)
    return out


def _public(name):
    return all(not p.startswith("_") or (p.startswith("__")
                                         and p.endswith("__"))
               for p in name.split("."))


def _renamed(name):
    return ".".join(RENAMES.get(p, (p,))[0] for p in name.split("."))


def _missing(rel):
    """Public names of reference module `rel` that its port lacks."""
    ref = _names(os.path.join(REF, rel))
    port = _names(os.path.join(PORT, MODULE_MAP.get(rel, rel)))
    return {n for n in ref if _public(n) and _renamed(n) not in port}


@pytest.mark.parametrize("rel", _ref_modules())
def test_module_names_have_port_counterparts(rel):
    port_rel = MODULE_MAP.get(rel, rel)
    port_path = os.path.join(PORT, port_rel)
    if rel in NO_COUNTERPART:
        assert not os.path.exists(port_path), \
            f"{rel} is allowlisted as having no counterpart, but " \
            f"parsec_tpu_torch/{port_rel} exists: drop the entry"
        return
    assert os.path.exists(port_path), \
        f"parsec_tpu/{rel} has no counterpart parsec_tpu_torch/{port_rel}"
    missing = sorted(n for n in _missing(rel) if (rel, n) not in NAME_ALLOW)
    assert not missing, \
        f"parsec_tpu_torch/{port_rel} lacks {missing} of parsec_tpu/{rel}"


def test_name_allowlist_names_real_gaps():
    """Every allowlisted name exists in the reference and not in the
    port; every rename's target is a name of the port."""
    for (rel, name), why in NAME_ALLOW.items():
        assert why
        assert name in _names(os.path.join(REF, rel)), (rel, name)
        port = _names(os.path.join(PORT, MODULE_MAP.get(rel, rel)))
        assert _renamed(name) not in port, \
            f"parsec_tpu_torch has {name} of {rel} now: drop its entry"
    ref_all, port_all = set(), set()
    for root, parts in ((REF, ref_all), (PORT, port_all)):
        for d, _, files in os.walk(root):
            for f in files:
                if f.endswith(".py"):
                    for n in _names(os.path.join(d, f)):
                        parts.update(n.split("."))
    for old, (new, why) in RENAMES.items():
        assert why
        assert old in ref_all, f"rename of {old}: not a reference name"
        assert new in port_all, f"rename to {new}: not a port name"
    for rel, why in NO_COUNTERPART.items():
        assert why and os.path.exists(os.path.join(REF, rel)), rel


def _sigs(path):
    """{symbol: signature source} of a binding's `_sigs` table."""
    for n in _parse(path).body:
        if isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "_sigs"
                for t in n.targets):
            return {k.value: ast.unparse(v)
                    for k, v in zip(n.value.keys, n.value.values)}
    raise AssertionError(f"no _sigs table in {path}")


def test_native_bindings_cover_the_reference():
    ref = _sigs(os.path.join(REF, "_native.py"))
    port = _sigs(os.path.join(PORT, "_native.py"))
    missing = sorted(set(ref) - set(port))
    assert not missing, f"parsec_tpu_torch/_native.py binds none of {missing}"
    differ = {k: (ref[k], port[k]) for k in ref if ref[k] != port[k]}
    assert not differ, f"signatures differ from the reference's: {differ}"


def test_native_bindings_are_declared_by_the_core():
    """Each bound symbol is declared by native/parsec_core.h (a symbol
    the core does not export raises when the binding loads)."""
    with open(os.path.join(ROOT, "native", "parsec_core.h")) as f:
        header = f.read()
    port = _sigs(os.path.join(PORT, "_native.py"))
    undeclared = sorted(s for s in port
                        if not re.search(rf"\b{s}\s*\(", header))
    assert not undeclared, undeclared


def _int_consts(path, prefix):
    out = {}
    for n in _parse(path).body:
        if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                isinstance(n.targets[0], ast.Name) and \
                n.targets[0].id.startswith(prefix):
            out[n.targets[0].id] = ast.literal_eval(n.value)
    return out


def test_debug_subsystem_ids_mirror_the_core():
    """DBG_* ids are PTC_DBG_* of parsec_core.h, and DBG_SUBSYSTEMS lists
    the subsystems by id, in both bindings."""
    with open(os.path.join(ROOT, "native", "parsec_core.h")) as f:
        enum = {k: int(v) for k, v in
                re.findall(r"PTC_DBG_(\w+)\s*=\s*(\d+)", f.read())}
    n = enum.pop("NSUBSYS")
    for pkg in (REF, PORT):
        got = _int_consts(os.path.join(pkg, "_native.py"), "DBG_")
        subs = got.pop("DBG_SUBSYSTEMS")
        assert got == {f"DBG_{k}": v for k, v in enum.items()}, pkg
        assert len(subs) == n and all(
            got[f"DBG_{s.upper()}"] == i for i, s in enumerate(subs)), pkg


def _knobs(path):
    """{name: (default source, type source)} of the module-level
    register(...) calls."""
    out = {}
    for n in _parse(path).body:
        if isinstance(n, ast.Expr) and isinstance(n.value, ast.Call) and \
                getattr(n.value.func, "id", None) == "register":
            a = n.value.args
            out[a[0].value] = (ast.unparse(a[1]), ast.unparse(a[2]))
    return out


def _comm_knobs():
    for n in _parse(os.path.join(PORT, "comm", "topology.py")).body:
        if isinstance(n, ast.AnnAssign) and \
                getattr(n.target, "id", None) == "COMM_KNOBS":
            return ast.literal_eval(n.value)
    raise AssertionError("no COMM_KNOBS in parsec_tpu_torch/comm/topology.py")


def test_knobs_cover_the_reference():
    ref = _knobs(os.path.join(REF, "utils", "config.py"))
    port = _knobs(os.path.join(PORT, "utils", "config.py"))
    consts = _comm_knobs()
    missing = sorted(k for k in ref
                     if k not in port and k not in consts
                     and k not in KNOB_ALLOW)
    assert not missing, f"the port registers none of {missing}"
    differ = {k: (ref[k], port[k]) for k in ref
              if k in port and ref[k] != port[k]}
    assert not differ, f"(default, type) differ from the reference's: " \
        f"{differ}"
    for k, v in consts.items():
        assert k not in port, f"{k} is both registered and a constant"
        assert ast.literal_eval(ref[k][0]) == v, (k, ref[k][0], v)
    for k, why in KNOB_ALLOW.items():
        assert why and k in ref and k not in port and k not in consts, k
