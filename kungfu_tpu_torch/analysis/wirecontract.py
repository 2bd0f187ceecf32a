"""wire-contract checker: Python↔C++ framing must agree byte-for-byte.

Port of ``kungfu_tpu/analysis/wirecontract.py``: the same rule over the
port's tree.

The host channel's wire format lives twice: :mod:`kungfu_tpu_torch.comm.host`
packs it with :class:`HeaderCodec` (``struct`` format strings) and
``native/transport.cpp`` decodes it with ``get_u16``/``get_u32`` reads
at hand-computed offsets.  A one-byte drift between them — a widened
field, a reordered pair, a changed magic — is invisible to either
side's unit tests and surfaces as a cluster-wide decode hang.  This
checker parses BOTH sides into one schema IR and diffs them:

* **fixed-field sequence** — the ordered widths of the non-variable
  header fields (``magic u32 | token u32 | conn_type u8 | src_len u16``
  then ``name_len u16`` and ``payload_len u32``), extracted from the
  ``HeaderCodec`` format constants (Python) and from
  ``encode_head``/``decode_head`` (C++: ``put_u32``→u32, ``put_u16``→
  u16, ``push_back``→u8; ``get_u32(head+k)``/``head[k]`` reads with
  offset-contiguity checking);
* **header prefix size** — ``struct.calcsize(HEAD_FMT)`` must equal the
  C++ ``uint8_t head[N]`` stack buffer;
* **shared constants** — ``MAGIC``/``kMagic``, ``MAX_FRAME``/
  ``kMaxFrame``, ``MAX_META_LEN``/``kMaxMetaLen`` evaluated and
  compared as integers;
* **codec bypass** — a raw ``struct.pack``/``unpack`` format literal
  inside the framing functions that is not one of the ``HeaderCodec``
  constants (a second copy is exactly how drift starts).

Both files must be present for the diff to run (a partial fixture tree
lints as empty).  Endianness is pinned little ("<" / the C++
shift-composed reads).
"""

from __future__ import annotations

import ast
import os
import re
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kungfu_tpu_torch.analysis.core import Violation, parse_module, read_lines

CHECKER = "wire-contract"

HOST_PATH = os.path.join("kungfu_tpu_torch", "comm", "host.py")
CPP_PATH = os.path.join("kungfu_tpu_torch", "native", "transport.cpp")

#: struct letters (little-endian) -> width; case-normalized (the wire
#: contract is width + order; all live fields are unsigned and bounded)
_WIDTHS = {"B": 1, "H": 2, "I": 4, "L": 4, "Q": 8}

#: Python framing scopes whose struct literals must come from the codec
_PY_FRAMING_FUNCS = {"_encode_head", "_encode", "_decode", "HeaderCodec"}

#: constant pairs diffed across the two languages
_CONST_PAIRS = (("MAGIC", "kMagic"), ("MAX_FRAME", "kMaxFrame"),
                ("MAX_META_LEN", "kMaxMetaLen"))


@dataclass
class Schema:
    fields: List[str] = field(default_factory=list)  # canonical letters
    head_size: Optional[int] = None  # fixed-prefix byte count
    consts: Dict[str, int] = field(default_factory=dict)
    lines: Dict[str, int] = field(default_factory=dict)  # anchor -> line
    errors: List[Tuple[int, str]] = field(default_factory=list)


def _const_fold(node: ast.AST) -> Optional[int]:
    """Evaluate the small integer expressions the contract uses
    (``3 << 30``, ``0x4B465450``, ``4096``)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    if isinstance(node, ast.BinOp):
        lhs, rhs = _const_fold(node.left), _const_fold(node.right)
        if lhs is None or rhs is None:
            return None
        if isinstance(node.op, ast.LShift):
            return lhs << rhs
        if isinstance(node.op, ast.Mult):
            return lhs * rhs
        if isinstance(node.op, ast.Add):
            return lhs + rhs
        if isinstance(node.op, ast.Sub):
            return lhs - rhs
        if isinstance(node.op, ast.BitOr):
            return lhs | rhs
    return None


#: width -> canonical letter: the contract is WIDTH + order, so "<LLBH"
#: (byte-identical to "<IIBH" under "<") must not read as drift
_CANONICAL = {1: "B", 2: "H", 4: "I", 8: "Q"}


def _fmt_letters(fmt: str) -> Optional[List[str]]:
    """``"<IIBH"`` -> ["I","I","B","H"] (width-canonicalized: ``L`` and
    ``I`` both -> "I"); None for a non-LE or unknown format (the
    contract is pinned little-endian)."""
    body = fmt
    if body[:1] in ("<", ">", "=", "!", "@"):
        if body[0] != "<":
            return None
        body = body[1:]
    out = []
    for ch in body:
        if ch.upper() not in _WIDTHS:
            return None
        out.append(_CANONICAL[_WIDTHS[ch.upper()]])
    return out


# -- Python side -------------------------------------------------------------

def python_schema(path: str) -> Schema:
    s = Schema()
    tree = parse_module(path).tree
    if tree is None:
        raise SyntaxError(f"{path}: unparseable")

    codec: Optional[ast.ClassDef] = None
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == "HeaderCodec":
            codec = node
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if name in ("MAGIC", "MAX_FRAME", "MAX_META_LEN"):
                val = _const_fold(node.value)
                if val is not None:
                    s.consts[name] = val
                    s.lines[name] = node.lineno

    fmt_values: List[str] = []
    if codec is not None:
        s.lines["HeaderCodec"] = codec.lineno
        for node in codec.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name) and \
                    node.targets[0].id.endswith("_FMT") and \
                    isinstance(node.value, ast.Constant) and \
                    isinstance(node.value.value, str):
                fmt_values.append(node.value.value)
                s.lines.setdefault("fmt", node.lineno)
    if not fmt_values:
        s.errors.append((1, "no HeaderCodec *_FMT constants found — the "
                            "wire checker has lost its Python anchor"))
        return s

    for fmt in fmt_values:
        letters = _fmt_letters(fmt)
        if letters is None:
            s.errors.append((s.lines.get("fmt", 1),
                             f"unparseable/non-little-endian header format "
                             f"{fmt!r}"))
            return s
        s.fields.extend(letters)
    try:
        s.head_size = struct.calcsize(fmt_values[0])
    except struct.error as e:
        s.errors.append((s.lines.get("fmt", 1),
                         f"struct.calcsize({fmt_values[0]!r}) failed: {e}"))

    # codec-bypass scan: any struct format literal in the framing
    # functions must be one of the codec constants' values
    allowed = set(fmt_values)
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            continue
        if node.name not in _PY_FRAMING_FUNCS:
            continue
        for call in ast.walk(node):
            if not isinstance(call, ast.Call) or not call.args:
                continue
            f = call.func
            attr = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None
            )
            if attr not in ("pack", "unpack", "pack_into", "unpack_from",
                            "calcsize"):
                continue
            arg = call.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str) \
                    and arg.value not in allowed:
                s.errors.append((call.lineno,
                                 f"raw struct format {arg.value!r} in "
                                 f"{node.name} bypasses HeaderCodec — the "
                                 f"single wire anchor"))
    return s


# -- C++ side ----------------------------------------------------------------

def _cpp_function_body(lines: List[str], name: str) -> Tuple[int, List[str]]:
    """(1-based start line, body lines) of function ``name`` by brace
    matching; ([], 0) when absent."""
    sig = re.compile(r"\b" + re.escape(name) + r"\s*\(")
    for i, line in enumerate(lines):
        if not sig.search(line) or ";" in line.split("//")[0].replace(
                ") {", ")").split("{")[0] and "{" not in line:
            continue
        if sig.search(line) and ("{" in line or "{" in "".join(
                lines[i:i + 3])):
            depth = 0
            body: List[str] = []
            started = False
            for j in range(i, len(lines)):
                code = lines[j].split("//")[0]
                depth += code.count("{") - code.count("}")
                body.append(lines[j])
                if "{" in code:
                    started = True
                if started and depth <= 0:
                    return i + 1, body
            break
    return 0, []


def cpp_schema(path: str) -> Schema:
    s = Schema()
    lines = read_lines(path)
    text = "\n".join(lines)

    for pyname, cppname in _CONST_PAIRS:
        m = re.search(re.escape(cppname) + r"\s*=\s*([^;]+);", text)
        if not m:
            continue
        expr = m.group(1).split("//")[0].strip()
        s.lines[cppname] = text[:m.start()].count("\n") + 1
        lit = re.fullmatch(r"(0[xX][0-9a-fA-F]+|\d+)[uU]?[lL]{0,2}", expr)
        shift = re.fullmatch(r"(\d+)[uU]?[lL]{0,2}\s*<<\s*(\d+)", expr)
        if lit:
            s.consts[cppname] = int(lit.group(1), 0)
        elif shift:
            s.consts[cppname] = int(shift.group(1)) << int(shift.group(2))

    # encode_head: ordered put/push tokens are the field sequence
    enc_line, enc = _cpp_function_body(lines, "encode_head")
    if not enc:
        s.errors.append((1, "encode_head not found in transport.cpp — the "
                            "wire checker has lost its C++ encode anchor"))
    else:
        s.lines["encode_head"] = enc_line
        for ln in enc:
            code = ln.split("//")[0]
            for m in re.finditer(
                    r"\b(put_u32|put_u16|push_back)\s*\(", code):
                s.fields.append({"put_u32": "I", "put_u16": "H",
                                 "push_back": "B"}[m.group(1)])

    # decode_head: head[N] buffer + offset-addressed reads, then the
    # trailing length reads
    dec_line, dec = _cpp_function_body(lines, "decode_head")
    if not dec:
        s.errors.append((1, "decode_head not found in transport.cpp — the "
                            "wire checker has lost its C++ decode anchor"))
        return s
    s.lines["decode_head"] = dec_line
    decode_fields: List[Tuple[int, int, str]] = []  # (offset, width, letter)
    tail_fields: List[str] = []
    head_size = None
    for ln in dec:
        code = ln.split("//")[0]
        m = re.search(r"uint8_t\s+head\s*\[\s*(\d+)\s*\]", code)
        if m:
            head_size = int(m.group(1))
            continue
        for m in re.finditer(r"\b(get_u32|get_u16)\s*\(\s*(\w+)"
                             r"(?:\s*\+\s*(\d+))?\s*\)", code):
            width, letter = (4, "I") if m.group(1) == "get_u32" else (2, "H")
            if m.group(2) == "head":
                decode_fields.append((int(m.group(3) or 0), width, letter))
            else:
                tail_fields.append(letter)
        if "uint8_t" not in code:
            for m in re.finditer(r"\bhead\s*\[\s*(\d+)\s*\]", code):
                decode_fields.append((int(m.group(1)), 1, "B"))
    s.head_size = head_size
    if head_size is None:
        s.errors.append((dec_line, "decode_head has no `uint8_t head[N]` "
                                   "fixed prefix"))
        return s
    decode_fields.sort()
    off = 0
    dec_letters: List[str] = []
    for field_off, width, letter in decode_fields:
        if field_off != off:
            s.errors.append((
                dec_line,
                f"decode_head field at offset {field_off} does not follow "
                f"the previous field (expected offset {off}) — gap or "
                f"overlap in the fixed header reads"))
            return s
        dec_letters.append(letter)
        off += width
    if off != head_size:
        s.errors.append((
            dec_line,
            f"decode_head reads {off} bytes of fixed fields out of a "
            f"head[{head_size}] prefix — size and reads drifted"))
    dec_letters.extend(tail_fields)
    # the decode sequence must equal the encode sequence (C++-internal)
    if s.fields and dec_letters != s.fields:
        s.errors.append((
            dec_line,
            f"transport.cpp decode_head field sequence "
            f"{''.join(dec_letters)} != encode_head sequence "
            f"{''.join(s.fields)}"))
    if not s.fields:
        s.fields = dec_letters
    return s


# -- the diff ----------------------------------------------------------------

def check(root: str) -> List[Violation]:
    host = os.path.join(root, HOST_PATH)
    cpp = os.path.join(root, CPP_PATH)
    if not (os.path.isfile(host) and os.path.isfile(cpp)):
        return []  # partial tree (fixture layouts): nothing to diff
    host_rel = HOST_PATH.replace(os.sep, "/")
    cpp_rel = CPP_PATH.replace(os.sep, "/")

    py = python_schema(host)
    cc = cpp_schema(cpp)
    out: List[Violation] = []
    for line, msg in py.errors:
        out.append(Violation(CHECKER, host_rel, line, msg))
    for line, msg in cc.errors:
        out.append(Violation(CHECKER, cpp_rel, line, msg))
    if py.errors or cc.errors:
        return out

    if py.fields != cc.fields:
        out.append(Violation(
            CHECKER, host_rel, py.lines.get("fmt", 1),
            f"Python fixed-field sequence {''.join(py.fields)} != C++ "
            f"{''.join(cc.fields)} (transport.cpp encode_head/decode_head) "
            f"— the two decoders will misparse each other's frames"))
    if py.head_size is not None and cc.head_size is not None and \
            py.head_size != cc.head_size:
        out.append(Violation(
            CHECKER, host_rel, py.lines.get("fmt", 1),
            f"HeaderCodec.HEAD_SIZE={py.head_size} but transport.cpp reads "
            f"a head[{cc.head_size}] fixed prefix — framing offset drift"))
    for pyname, cppname in _CONST_PAIRS:
        if pyname in py.consts and cppname in cc.consts and \
                py.consts[pyname] != cc.consts[cppname]:
            out.append(Violation(
                CHECKER, host_rel, py.lines.get(pyname, 1),
                f"{pyname}={py.consts[pyname]:#x} != transport.cpp "
                f"{cppname}={cc.consts[cppname]:#x} — shared wire constant "
                f"drifted"))
        elif pyname not in py.consts:
            out.append(Violation(
                CHECKER, host_rel, 1,
                f"{pyname} constant not found in comm/host.py — the wire "
                f"checker has lost an anchor"))
        elif cppname not in cc.consts:
            out.append(Violation(
                CHECKER, cpp_rel, 1,
                f"{cppname} constant not found in transport.cpp — the wire "
                f"checker has lost an anchor"))
    return sorted(out, key=lambda v: (v.path, v.line))
