"""The port's native generic-MDP compiler against `cpr_tpu`'s.

The port builds its own copy of the C++ BFS compiler
(`cpr_tpu_torch/native/src/generic_compiler.cpp`) with g++ into
`build/cpr_tpu_torch/`; compiles must give columns identical to the JAX
package's (exact: same source, same flags), and flag errors the same
messages. The copy of the source must stay byte-identical to the
reference's; this test reads both files and imports neither.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from cpr_tpu.mdp.generic.native import compile_native as j_compile_native
from cpr_tpu_torch import native
from cpr_tpu_torch.mdp.generic import compile_native

ROOT = Path(__file__).resolve().parents[1]
CASES = [("bitcoin", 0, 5), ("ghostdag", 2, 5), ("parallel", 2, 4),
         ("ethereum", 3, 4), ("byzantium", 3, 4)]


def test_source_is_byte_identical_to_the_reference():
    port = ROOT / "cpr_tpu_torch" / "native" / "src" / "generic_compiler.cpp"
    ref = ROOT / "cpr_tpu" / "native" / "src" / "generic_compiler.cpp"
    assert port.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("proto,k,cutoff", CASES,
                         ids=[f"{p}-{c}" for p, _, c in CASES])
def test_compile_matches_reference(proto, k, cutoff):
    kw = dict(k=k, alpha=0.3, gamma=0.5, collect_garbage="simple",
              dag_size_cutoff=cutoff)
    got, want = compile_native(proto, **kw), j_compile_native(proto, **kw)
    assert (got.n_states, got.n_actions) == (want.n_states, want.n_actions)
    assert got.start == want.start
    for g, w in zip(got.arrays(), want.arrays()):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("flags", [
    dict(proto="ghostdag", k=2, dag_size_cutoff=4, merge_isomorphic=False),
    dict(proto="bitcoin", collect_garbage="judge", dag_size_cutoff=4),
    dict(proto="ghostdag", k=2, dag_size_cutoff=4, loop_honest=True,
         truncate_common_chain=False),
], ids=["no-merge", "judge-gc", "loop-honest"])
def test_flag_variants_match_reference(flags):
    flags = dict(flags, alpha=0.25, gamma=0.5)
    got, want = compile_native(**flags), j_compile_native(**flags)
    for g, w in zip(got.arrays(), want.arrays()):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("flags", [
    dict(proto="bitcoin"),
    dict(proto="bitcoin", dag_size_cutoff=10_000),
    dict(proto="bitcoin", dag_size_cutoff=4, loop_honest=True),
    dict(proto="bitcoin", dag_size_cutoff=4, truncate_common_chain=False,
         reward_common_chain=True),
    dict(proto="nonesuch", dag_size_cutoff=4),
    dict(proto="ghostdag", k=2, dag_size_cutoff=6, max_states=10),
], ids=["no-cutoff", "cutoff-too-large", "loop-and-truncate",
        "reward-without-truncate", "unknown-protocol", "state-cap"])
def test_flag_errors_match_reference(flags):
    flags = dict(flags, alpha=0.3, gamma=0.5)
    with pytest.raises(RuntimeError) as got:
        compile_native(**flags)
    with pytest.raises(RuntimeError) as want:
        j_compile_native(**flags)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("native compile failed: ")
    with pytest.raises(KeyError):
        compile_native("bitcoin", alpha=0.3, gamma=0.5, dag_size_cutoff=4,
                       collect_garbage="sometimes")


def test_library_lands_in_the_build_dir_by_hash(tmp_path, monkeypatch):
    monkeypatch.setenv("CPR_TORCH_BUILD_DIR", str(tmp_path))
    src = tmp_path / "tiny.cpp"
    src.write_text('extern "C" int tiny() { return 7; }\n')
    so = native.build_lib(src)
    assert so.parent == tmp_path and so.exists()
    assert so.name.startswith("libtiny-") and so.suffix == ".so"
    assert native.build_lib(src) == so  # present: not rebuilt
    assert native.load_lib(src).tiny() == 7
    assert not list(tmp_path.glob("*.tmp*"))  # built via rename
    src.write_text('extern "C" int tiny() { return 8; }\n')
    assert native.library_path(src) != so  # an edited source rebuilds
    assert native.library_path(src, "-O3") != native.library_path(src)
    src.write_text("not c++\n")
    with pytest.raises(RuntimeError, match="native build failed"):
        native.build_lib(src)
    assert not list(tmp_path.glob("*.tmp*"))
