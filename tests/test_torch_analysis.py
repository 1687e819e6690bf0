"""The port's static-analysis gate (``ps_tpu_torch/analysis``, ROADMAP
Queue 1 item 6.5) against the reference's pslint, on the CPU.

(a) Parity: every fixture tree of ``tests/test_analysis.py`` — the
    reference's own seeded-violation corpus, Python and C++ — is linted by
    ``ps_tpu.analysis.run_lint`` and ``ps_tpu_torch.analysis.run_lint``
    with the same arguments at the same moment, and the two give the same
    ``(rule, severity, line)`` list. Each reference test body runs as it
    is (its own assertions hold the reference); ``run_lint`` is wrapped to
    lint with both packages, and its CLI runs in process. The final tree
    is then linted whole by both.
(b) The CUDA cases: ``.cu`` fixtures with their ctypes sites, the types
    the port's kernel ABI crosses (``long long``, ``float``, a
    ``const char*`` return), exports per library, and CUDA syntax the
    C++ model must read without a finding.
(c) The gate: the port's tree lints clean with its default context, every
    suppression in it carries a reason, and the CLI's exit codes.
"""

from __future__ import annotations

import contextlib
import importlib.util
import inspect
import io
import json
import os
import subprocess
import sys
import textwrap

import pytest

import ps_tpu.analysis as ref_analysis
import ps_tpu_torch.analysis as port_analysis
from ps_tpu_torch.analysis import __main__ as port_cli
from ps_tpu_torch.analysis.cpp import CppSourceFile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_REF_TESTS = _load("_ref_test_analysis",
                   os.path.join(REPO, "tests", "test_analysis.py"))
_REF_CLI = _load("_ref_pslint", os.path.join(REPO, "tools", "pslint.py"))

#: the reference's fixture tests: every test of tests/test_analysis.py
#: that lints a tree it writes into tmp_path
FIXTURES = sorted(
    name for name, fn in vars(_REF_TESTS).items()
    if name.startswith("test_") and callable(fn)
    and list(inspect.signature(fn).parameters) == ["tmp_path"])


def _triples(findings):
    return [(f.rule, f.severity, f.line) for f in findings]


def _both(args, kwargs):
    """Lint with both packages; a raise must be the same raise."""
    out = []
    for pkg in (ref_analysis, port_analysis):
        try:
            out.append(_triples(pkg.run_lint(*args, **kwargs)))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    return out


class _InProcess:
    """``subprocess`` for the reference test module: runs its CLI
    (``tools/pslint.py``) in this process, so a case costs no start-up."""

    CompletedProcess = subprocess.CompletedProcess

    @staticmethod
    def run(cmd, capture_output=True, text=True, timeout=None):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                rc = _REF_CLI.main(list(cmd[2:]))
            except SystemExit as e:
                rc = e.code
        return subprocess.CompletedProcess(cmd, rc, out.getvalue(),
                                           err.getvalue())


@pytest.mark.parametrize("fixture", FIXTURES)
def test_parity_with_the_reference_on_its_fixture(fixture, tmp_path,
                                                  monkeypatch):
    pairs = []

    def run_lint(*args, **kwargs):
        pairs.append((args, kwargs, _both(args, kwargs)))
        return ref_analysis.run_lint(*args, **kwargs)

    monkeypatch.setattr(_REF_TESTS, "run_lint", run_lint)
    monkeypatch.setattr(_REF_TESTS, "subprocess", _InProcess)
    getattr(_REF_TESTS, fixture)(tmp_path)
    pairs.append(("final tree", {}, _both(([str(tmp_path)],), {})))
    for args, kwargs, (ref, port) in pairs:
        assert port == ref, (args, kwargs)


def test_rule_registry_equals_the_reference():
    ref = {p: doc for p, (doc, _fn) in ref_analysis.all_rules().items()}
    port = {p: doc for p, (doc, _fn) in port_analysis.all_rules().items()}
    assert sorted(port) == sorted(ref) == [f"PSL{i}" for i in range(1, 7)]


def test_every_rule_id_and_severity_equals_the_reference():
    """The concrete ids each package can emit, with their severities, read
    off the ``Finding("PSLnnn", "Pn", ...)`` sites of both sources."""
    import re

    def emitted(pkg):
        root = os.path.dirname(pkg.__file__)
        pairs = set()
        for name in os.listdir(root):
            if name.endswith(".py"):
                with open(os.path.join(root, name), encoding="utf-8") as f:
                    text = f.read()
                pairs |= set(re.findall(
                    r'(?:Finding\(|rule_id=)\s*"(PSL\d{3})",?\s*(?:"(P\d)")?',
                    text))
        return pairs

    port = emitted(port_analysis)
    assert port == emitted(ref_analysis)
    assert {"PSL101", "PSL203", "PSL406", "PSL502", "PSL601",
            "PSL604"} <= {rule for rule, _sev in port}


# -- (b) the CUDA cases ---------------------------------------------------------


def _write(tmp_path, name, src):
    p = tmp_path / name
    p.write_text(textwrap.dedent(src))
    return str(p)


def _lint(tmp_path, rules=("PSL6",)):
    return port_analysis.run_lint([str(tmp_path)], rules=list(rules))


#: a kernel library's C interface in the port's idiom: long long sizes,
#: float hyper-parameters, a stream handle, an error string
_KERNEL_CU = """
    #include <cuda_runtime.h>
    namespace {
    __global__ void k_kernel(float* x, long long n) {}
    }  // namespace

    extern "C" {

    int ps_k_apply(int rule, void* table, const void* ids, long long n,
                   long long dim, float lr, int device, void* stream) {
      k_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<float*>(table), n);
      return static_cast<int>(cudaGetLastError());
    }

    const char* ps_k_error_string(int code) {
      return cudaGetErrorString(static_cast<cudaError_t>(code));
    }

    }  // extern "C"
    """

_KERNEL_PY = """
    import ctypes

    from pkg import _build


    def _lib():
        lib = _build.load("kern")
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.ps_k_apply.argtypes = [i, p, p, ll, ll, f, i, p]
        lib.ps_k_apply.restype = i
        lib.ps_k_error_string.argtypes = [i]
        lib.ps_k_error_string.restype = ctypes.c_char_p
        return lib


    def launch(table, ids, n, dim, lr, stream):
        lib = _lib()
        rc = lib.ps_k_apply(0, table, ids, n, dim, lr, 0, stream)
        return lib.ps_k_error_string(rc)
    """


def _kernel_tree(tmp_path, py=_KERNEL_PY, cu=_KERNEL_CU):
    _write(tmp_path, "kern.cu", cu)
    _write(tmp_path, "bind.py", py)


def test_cuda_matching_kernel_abi_is_clean(tmp_path):
    _kernel_tree(tmp_path)
    assert _lint(tmp_path, ("PSL5", "PSL6")) == []


@pytest.mark.parametrize("decl,param", [
    ("[i, p, p, i, ll, f, i, p]", "long long"),
    ("[i, p, p, ll, ll, i, i, p]", "float"),
    ("[i, p, p, ll, ll, ctypes.c_double, i, p]", "float"),
    ("[i, i, p, ll, ll, f, i, p]", "void*"),
])
def test_cuda_param_width_or_kind_is_psl601(tmp_path, decl, param):
    _kernel_tree(tmp_path, py=_KERNEL_PY.replace(
        "[i, p, p, ll, ll, f, i, p]", decl))
    f = _lint(tmp_path)
    assert _triples(f) == [("PSL601", "P0", 11)], f
    assert f"is {param}" in f[0].message
    assert "int ps_k_apply(int rule, void* table" in f[0].message
    assert "kern.cu" in f[0].message


def test_cuda_arity_is_psl601(tmp_path):
    _kernel_tree(tmp_path, py=_KERNEL_PY.replace(
        "[i, p, p, ll, ll, f, i, p]", "[i, p, p, ll, ll, f, i]"))
    f = _lint(tmp_path)
    assert _triples(f) == [("PSL601", "P0", 11)]
    assert "arity 7 != 8" in f[0].message


def test_cuda_const_char_return_needs_a_restype(tmp_path):
    _kernel_tree(tmp_path, py=_KERNEL_PY.replace(
        "        lib.ps_k_error_string.restype = ctypes.c_char_p\n", ""))
    f = _lint(tmp_path)
    assert _triples(f) == [("PSL602", "P0", 13)]
    assert "const char* ps_k_error_string(int code)" in f[0].message
    _kernel_tree(tmp_path, py=_KERNEL_PY.replace(
        "ctypes.c_char_p", "ctypes.c_void_p"))
    assert _lint(tmp_path) == []
    _kernel_tree(tmp_path, py=_KERNEL_PY.replace(
        "ctypes.c_char_p", "ctypes.c_int"))
    assert _triples(_lint(tmp_path)) == [("PSL602", "P0", 14)]


def test_cuda_renamed_extern_c_is_psl604(tmp_path):
    _kernel_tree(tmp_path, cu=_KERNEL_CU.replace("ps_k_apply(",
                                                 "ps_k_apply_v2("))
    f = _lint(tmp_path)
    assert sorted(_triples(f)) == [("PSL604", "P1", 11),
                                   ("PSL604", "P2", 9)], f
    assert {x.path.rsplit("/", 1)[-1] for x in f} == {"bind.py", "kern.cu"}
    assert any("ps_k_apply_v2" in x.message for x in f)


_SHARED_CU = """
    extern "C" {{
    int ps_{lib}_run(long long n, void* stream) {{ return 0; }}
    const char* ps_err(int code) {{ return ""; }}
    }}
    """

_SHARED_PY = """
    import ctypes

    from pkg import _build


    def _{lib}():
        lib = _build.load("{lib}")
        lib.ps_{lib}_run.argtypes = [ctypes.c_longlong, ctypes.c_void_p]
        lib.ps_err.argtypes = [ctypes.c_int]
        lib.ps_err.restype = ctypes.c_char_p
        return lib
    """


def _shared_tree(tmp_path, bind=("alpha", "beta")):
    for lib in ("alpha", "beta"):
        _write(tmp_path, f"{lib}.cu", _SHARED_CU.format(lib=lib))
        if lib in bind:
            _write(tmp_path, f"{lib}_bind.py", _SHARED_PY.format(lib=lib))


def test_one_symbol_in_two_libraries_each_bound_once_is_clean(tmp_path):
    _shared_tree(tmp_path)
    assert _lint(tmp_path) == []


def test_one_symbol_in_two_libraries_is_two_exports(tmp_path):
    """Exports are per library: ``ps_err`` bound only for ``alpha`` leaves
    ``beta``'s export unbound; and a library's binding of a symbol only
    another library exports is drift."""
    _shared_tree(tmp_path, bind=("alpha",))
    f = _lint(tmp_path)
    assert [(x.rule, x.severity, x.path.rsplit("/", 1)[-1], x.line)
            for x in f] == [("PSL604", "P2", "beta.cu", 3),
                            ("PSL604", "P2", "beta.cu", 4)]
    _shared_tree(tmp_path)
    _write(tmp_path, "alpha_bind.py", _SHARED_PY.format(lib="alpha").replace(
        "lib.ps_alpha_run.", "lib.ps_beta_run."))
    f = _lint(tmp_path)
    assert ("PSL604", "P1", 9) in _triples(f)
    assert any("'ps_beta_run' (library 'alpha')" in x.message for x in f)


def test_cuda_source_parses_with_no_finding(tmp_path):
    src = """
        // pslint: memcpy-bound: 64
        #include <cuda_runtime.h>
        #include <cstdint>
        #define PS_CHECK(x)                                  \\
          do {                                               \\
            cudaError_t e_ = (x);                            \\
            if (e_ != cudaSuccess) return static_cast<int>(e_); \\
          } while (0)

        namespace {
        constexpr int kThreads = 128;

        __device__ __forceinline__ uint32_t smem_u32(const void* p) {
          uint32_t a;
          asm volatile("{ .reg .u64 t; cvta.to.shared.u64 t, %1; "
                       "cvt.u32.u64 %0, t; }" : "=r"(a) : "l"(p));
          return a;
        }

        template <int D>
        __global__ void __launch_bounds__(kThreads, 1)
        tile_kernel(const float* __restrict__ x, float* y, long long n) {
          __shared__ float buf[D];
          asm volatile("bar.sync 0;" ::: "memory");
          if (threadIdx.x < D) buf[threadIdx.x] = x[threadIdx.x];
          y[0] = buf[0];
        }

        template <int D>
        cudaError_t launch(const float* x, float* y, long long n,
                           cudaStream_t s) {
          tile_kernel<D><<<dim3(1), dim3(kThreads), 0, s>>>(x, y, n);
          return cudaGetLastError();
        }
        }  // namespace

        extern "C" {

        int ps_tile(const void* x, void* y, long long n, int d,
                    void* stream) {
          cudaStream_t s = static_cast<cudaStream_t>(stream);
        #define PS_LAUNCH(D)                                           \\
          launch<D>(static_cast<const float*>(x), static_cast<float*>(y), \\
                    n, s)
          if (d == 16) PS_CHECK(PS_LAUNCH(16));
          else PS_CHECK(PS_LAUNCH(32));
        #undef PS_LAUNCH
          return 0;
        }

        }  // extern "C"
        """
    path = _write(tmp_path, "tile.cu", src)
    _write(tmp_path, "bind.py", """
        import ctypes


        def bind(lib):
            lib.ps_tile.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int64, ctypes.c_int,
                                    ctypes.c_void_p]
            lib.ps_tile.restype = ctypes.c_int
        """)
    assert port_analysis.run_lint([str(tmp_path)]) == []
    with open(path, encoding="utf-8") as f:
        sf = CppSourceFile(path, f.read())
    by_name = {fn.name: fn for fn in sf.functions}
    assert by_name["tile_kernel"].ret.split() == ["__global__", "void"]
    assert "__launch_bounds__" not in by_name["tile_kernel"].ret
    assert [fn.name for fn in sf.functions if fn.extern_c] == ["ps_tile"]
    assert "PS_CHECK" not in by_name and "PS_LAUNCH" not in by_name


def test_port_kernel_abi_mutation_is_caught(tmp_path):
    """The liveness drill on the port's own kernels: a copy of ``ops/``
    lints clean under PSL5/PSL6, and one ``ll`` turned to ``i`` in the
    sparse apply's argtypes is PSL601 naming the C signature."""
    import shutil

    ops = tmp_path / "ops"
    shutil.copytree(os.path.join(REPO, "ps_tpu_torch", "ops"), ops,
                    ignore=shutil.ignore_patterns("__pycache__"))
    assert port_analysis.run_lint([str(ops)], rules=["PSL5", "PSL6"]) == []
    src = (ops / "sparse_apply.py").read_text()
    bound = "p, p, p, p, p, p, p, p, p, ll,\n                                        ll,"
    assert bound in src
    (ops / "sparse_apply.py").write_text(src.replace(
        bound, "p, p, p, p, p, p, p, p, p, i,\n                                        ll,"))
    f = port_analysis.run_lint([str(ops)], rules=["PSL6"])
    assert [x.rule for x in f] == ["PSL601"]
    assert "argtypes[11] is c_int" in f[0].message
    assert "long long n" in f[0].message


def test_port_kernel_exports_per_library():
    """What ``chip_smoke.py`` holds against ``nm -D`` on the card: every
    kernel library of ``_build.KERNELS`` exports its ``ps_*`` entry
    points, and ``ps_cuda_error_string`` is two exports."""
    from ps_tpu_torch.analysis import RepoIndex
    from ps_tpu_torch.analysis.abi import exports_by_library
    from ps_tpu_torch.ops import _build

    got = exports_by_library(RepoIndex([str(_build.CSRC)]))
    assert {k: sorted(v) for k, v in got.items()} == {
        "sparse_group": ["ps_empty_launch", "ps_group_error_string",
                         "ps_sparse_group_cluster", "ps_sparse_group_sorted"],
        "sparse_apply": ["ps_cuda_error_string", "ps_sparse_apply"],
        "flash_attention": ["ps_cuda_error_string", "ps_flash_attention_fwd"],
    }
    assert sorted(got) == sorted(_build.KERNELS)
    n_params = sum(len(e.params) for v in got.values() for e in v.values())
    assert n_params == 64


# -- (c) the gate -----------------------------------------------------------------


def test_port_lints_clean():
    """THE gate: ps_tpu_torch/ stays clean under its default context."""
    context, readme = port_cli.default_context()
    findings = port_analysis.run_lint([os.path.join(REPO, "ps_tpu_torch")],
                                      context=context, readme=readme)
    assert findings == [], "\n" + "\n".join(f.format() for f in findings)


def test_port_suppressions_all_carry_reasons():
    context, readme = port_cli.default_context()
    idx = port_analysis.RepoIndex([os.path.join(REPO, "ps_tpu_torch")],
                                  context=context, readme=readme)
    n = 0
    for sf in idx.files + idx.cpp_files:
        for line, (ids, reason) in sf.suppressions.items():
            assert reason, f"{sf.path}:{line} suppression has no reason"
            n += 1
    assert n >= 40


def test_port_native_annotations_are_armed():
    """The port's van.cpp carries the contract PSL5 enforces."""
    path = os.path.join(REPO, "ps_tpu_torch", "native", "van.cpp")
    with open(path, encoding="utf-8") as f:
        sf = CppSourceFile(path, f.read())
    assert {"lock-order", "hot-lock", "transfers", "owns",
            "hot-path"} <= {a.key for a in sf.annotations}
    assert sf.bad_annotations == []


def test_cli_exits_zero_on_the_port():
    proc = subprocess.run(
        [sys.executable, "-m", "ps_tpu_torch.analysis",
         os.path.join(REPO, "ps_tpu_torch")],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "clean" in proc.stderr


def _cli(*argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = port_cli.main(list(argv))
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def test_cli_exits_one_on_findings_and_two_on_usage(tmp_path):
    _kernel_tree(tmp_path, py=_KERNEL_PY.replace(
        "[i, p, p, ll, ll, f, i, p]", "[i, p, p, i, ll, f, i, p]"))
    rc, out, _err = _cli(str(tmp_path), "--no-default-context", "--json")
    assert rc == 1 and [f["rule"] for f in json.loads(out)] == ["PSL601"]
    rc, out, _err = _cli(str(tmp_path), "--no-default-context", "--py-only")
    assert rc == 0
    rc, _out, err = _cli(str(tmp_path), "--rules", "PSL9")
    assert rc == 2 and "PSL9" in err
    rc, _out, _err = _cli(str(tmp_path), "--native-only", "--py-only")
    assert rc == 2
    rc, out, _err = _cli("--list-rules")
    assert rc == 0 and all(f"PSL{i}xx" in out for i in range(1, 7))
