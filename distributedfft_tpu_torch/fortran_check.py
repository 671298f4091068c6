"""Fortran-interface checker for ``csrc/dfft_fortran.f90``.

The port's copy of the JAX package's checker (``native/fortran_check.py``),
held to the port's own sources. Where no Fortran compiler exists, an
unchecked ``.f90`` would be a claim rather than a component. This checker
closes the gap that matters without one: it parses every ``bind(c)``
interface of the Fortran module and cross-validates it (name, arity,
argument C types, by value or by pointer, return type) against the
``extern "C"`` definitions in ``csrc/dfft_native.cpp``. A drifting
signature, the bug a compiler would catch at link or call time, fails
``tests/test_torch_fortran_binding.py`` on every platform; where
``gfortran`` exists, :func:`.native.build_fortran` compiles the module and
the tests run a transform driven from Fortran.

The parser is deliberately narrow: it understands exactly the F2003
ISO_C_BINDING subset the module uses (interface blocks of functions and
subroutines with scalar ``value`` dummies, assumed-size array dummies,
and ``type(c_ptr), value``), and raises on anything it cannot classify:
unknown constructs fail the check rather than pass silently.

Run ``python -m distributedfft_tpu_torch.fortran_check`` to check the
package's sources (exit 1 on a mismatch).
"""

from __future__ import annotations

import re
from pathlib import Path

# Fortran declaration -> C type, keyed by (type spec, is_value, is_array).
_F2C = {
    ("integer(c_long_long)", True, False): "long long",
    ("integer(c_int)", True, False): "int",
    ("real(c_double)", True, False): "double",
    ("real(c_float)", False, True): "float*",
    ("real(c_double)", False, True): "double*",
    ("complex(c_float_complex)", False, True): "float*",
    ("type(c_ptr)", True, False): "void*",
}

_F2C_RESULT = {
    "integer(c_long_long)": "long long",
    "integer(c_int)": "int",
    "real(c_double)": "double",
}


def _strip(line: str) -> str:
    return line.split("!", 1)[0].strip()


def _join_continuations(lines):
    out, cur = [], ""
    for raw in lines:
        line = _strip(raw)
        if not line:
            continue
        if cur:
            line = cur + " " + line
            cur = ""
        if line.endswith("&"):
            cur = line[:-1].rstrip()
            continue
        out.append(line)
    if cur:
        out.append(cur)
    return out


def parse_fortran_interfaces(path: str | Path) -> dict[str, dict]:
    """Parse ``bind(c)`` interface bodies: name -> {args, result}.

    ``args`` is an ordered list of (dummy name, c type string); ``result``
    the C return type ("void" for subroutines).
    """
    lines = _join_continuations(Path(path).read_text().splitlines())
    sigs: dict[str, dict] = {}
    i = 0
    head = re.compile(
        r"^(function|subroutine)\s+(\w+)\s*\(([^)]*)\)\s*bind\(c\)"
        r"(?:\s*result\s*\((\w+)\))?\s*$", re.I)
    while i < len(lines):
        m = head.match(lines[i])
        if not m:
            i += 1
            continue
        kind, name, argstr, result_var = m.groups()
        dummies = [a.strip().lower() for a in argstr.split(",") if a.strip()]
        decls: dict[str, tuple[str, bool, bool]] = {}
        i += 1
        while i < len(lines) and not re.match(
                rf"^end\s+{kind}\b", lines[i], re.I):
            line = lines[i]
            i += 1
            if re.match(r"^import\b", line, re.I):
                continue
            dm = re.match(
                r"^(integer\([\w]+\)|real\([\w]+\)|complex\([\w]+\)|"
                r"type\([\w]+\))\s*(.*?)::\s*(.+)$", line, re.I)
            if not dm:
                raise ValueError(f"{name}: unparsed declaration: {line!r}")
            spec, attrs, names = dm.groups()
            spec = spec.lower().replace(" ", "")
            attrs = attrs.lower()
            is_value = "value" in attrs
            is_array = "dimension(*)" in attrs.replace(" ", "")
            for nm in (x.strip().lower() for x in names.split(",")):
                decls[nm] = (spec, is_value, is_array)
        if kind.lower() == "function":
            rv = (result_var or name).lower()
            if rv not in decls:
                raise ValueError(f"{name}: result {rv} undeclared")
            spec, _, _ = decls.pop(rv)
            if spec not in _F2C_RESULT:
                raise ValueError(f"{name}: unmapped result type {spec}")
            result = _F2C_RESULT[spec]
        else:
            result = "void"
        args = []
        for nm in dummies:
            if nm not in decls:
                raise ValueError(f"{name}: dummy {nm} undeclared")
            key = decls[nm]
            if key not in _F2C:
                raise ValueError(f"{name}: unmapped dummy {nm}: {key}")
            args.append((nm, _F2C[key]))
        sigs[name.lower()] = {"args": args, "result": result}
        i += 1
    if not sigs:
        raise ValueError(f"no bind(c) interfaces found in {path}")
    return sigs


_C_TYPE = r"(?:const\s+)?(?:long\s+long|int|double|float|void|char)\s*\**"


def parse_c_exports(path: str | Path, names) -> dict[str, dict]:
    """Extract the extern-C signatures of ``names`` from the C++ source."""
    text = Path(path).read_text()
    out: dict[str, dict] = {}
    for name in names:
        m = re.search(
            rf"^((?:long\s+long|int|double|void))\s+{name}\s*\(([^)]*)\)",
            text, re.M | re.S)
        if not m:
            continue
        ret, argstr = m.groups()
        args = []
        for a in argstr.split(","):
            a = " ".join(a.split())
            if not a:
                continue
            am = re.match(rf"^({_C_TYPE})\s*(\w+)?$", a)
            if not am:
                raise ValueError(f"{name}: unparsed C arg {a!r}")
            t = am.group(1).replace("const ", "").replace(" *", "*").strip()
            # Pointer-ness collapses to one level; spaces normalized.
            t = re.sub(r"\s*\*+", "*", t)
            args.append(t)
        out[name] = {"args": args, "result": " ".join(ret.split())}
    return out


def check(f90_path: str | Path, cpp_path: str | Path) -> list[str]:
    """Return a list of mismatch messages (empty = interfaces line up)."""
    fsigs = parse_fortran_interfaces(f90_path)
    csigs = parse_c_exports(cpp_path, fsigs)
    problems = []
    for name, fs in fsigs.items():
        cs = csigs.get(name)
        if cs is None:
            problems.append(f"{name}: no extern-C definition found")
            continue
        if fs["result"] != cs["result"]:
            problems.append(
                f"{name}: result {fs['result']} (fortran) != "
                f"{cs['result']} (C)")
        fargs = [t for _, t in fs["args"]]
        if len(fargs) != len(cs["args"]):
            problems.append(
                f"{name}: arity {len(fargs)} (fortran) != "
                f"{len(cs['args'])} (C)")
            continue
        for j, (ft, ct) in enumerate(zip(fargs, cs["args"])):
            if ft == "void*" and ct.endswith("*"):
                continue  # type(c_ptr) matches any C pointer
            if ft != ct:
                problems.append(
                    f"{name}: arg {j} {ft} (fortran) != {ct} (C)")
    return problems


if __name__ == "__main__":
    import sys

    csrc = Path(__file__).parent / "csrc"
    issues = check(csrc / "dfft_fortran.f90", csrc / "dfft_native.cpp")
    for msg in issues:
        print("MISMATCH:", msg)
    print(f"{'FAIL' if issues else 'OK'}: "
          f"{len(parse_fortran_interfaces(csrc / 'dfft_fortran.f90'))} "
          f"interfaces checked")
    sys.exit(1 if issues else 0)
