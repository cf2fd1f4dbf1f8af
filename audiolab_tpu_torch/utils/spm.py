"""Pure-Python SentencePiece: ModelProto wire parser + encoder/decoder (a
copy of audiolab_tpu/utils/spm.py, which imports no framework: the port
keeps its own copy and imports nothing of the JAX package).

The reference's YuE tokenizer (modules/yue/inference/mmtokenizer.py:63-71)
and Stable-Audio's T5 conditioner both wrap `sentencepiece`, a C++ wheel
that is not available here.  This module reads the SAME ``.model``
protobuf files (sentencepiece_model.proto layout) and reproduces the
processor surface the reference code calls: ``encode_as_ids``,
``decode_ids``, ``id_to_piece``, ``pad_id/bos_id/eos_id/unk_id``,
``len()``.

Supported model types: UNIGRAM (Viterbi segmentation over piece scores,
unk penalty 10.0 like spm's kUnkPenalty) and BPE (highest-score adjacent
merge, leftmost tiebreak).  Byte-fallback pieces (``<0xXX>``) are used for
characters outside the vocab when the model enables them.

Normalization: the precompiled charsmap embedded in NormalizerSpec (the
nmt_nfkc rules compiled to a darts-clone double-array trie + replacement
string pool, normalizer.cc DecodePrecompiledCharsMap) IS parsed and
applied — longest-prefix transduction over UTF-8 bytes, then the exact
Normalize() whitespace loop (heading-space skip, dummy prefix, escaped
space collapse, trailing strip).  Models without a charsmap (identity
normalizer, test fixtures) skip the transduction.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

_WS = "▁"  # U+2581 LOWER ONE EIGHTH BLOCK, spm's escaped space

# SentencePiece.Type enum (sentencepiece_model.proto)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
UNIGRAM, BPE, WORD, CHAR = 1, 2, 3, 4
_UNK_PENALTY = 10.0


# ------------------------------------------------------------ wire format

def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a serialized message.
    value is int for varint/fixed, bytes for length-delimited."""
    i, n = 0, len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        fno, wt = tag >> 3, tag & 7
        if wt == 0:                      # varint
            v, i = _read_varint(buf, i)
        elif wt == 1:                    # fixed64
            v = struct.unpack_from("<Q", buf, i)[0]
            i += 8
        elif wt == 2:                    # length-delimited
            ln, i = _read_varint(buf, i)
            v = buf[i : i + ln]
            i += ln
        elif wt == 5:                    # fixed32
            v = struct.unpack_from("<I", buf, i)[0]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield fno, wt, v


def _zigzag_signed(v: int) -> int:
    """proto int32 fields arrive as unsigned varints; sign-extend."""
    return v - (1 << 64) if v >= (1 << 63) else (
        v - (1 << 32) if v >= (1 << 31) else v)


@dataclass
class SentencePieceModel:
    """Parsed sentencepiece ModelProto (the fields the processor needs)."""

    pieces: list[tuple[str, float, int]] = field(default_factory=list)
    model_type: int = UNIGRAM
    byte_fallback: bool = False
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1
    unk_piece: str = "<unk>"
    unk_surface: str = " ⁇ "
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True
    precompiled_charsmap: bytes = b""

    @classmethod
    def parse(cls, data: bytes) -> "SentencePieceModel":
        m = cls()
        for fno, wt, v in _iter_fields(data):
            if fno == 1 and wt == 2:            # repeated SentencePiece
                piece, score, typ = "", 0.0, NORMAL
                for pf, pw, pv in _iter_fields(v):
                    if pf == 1:
                        piece = pv.decode("utf-8")
                    elif pf == 2:
                        score = struct.unpack("<f", struct.pack("<I", pv))[0]
                    elif pf == 3:
                        typ = pv
                m.pieces.append((piece, score, typ))
            elif fno == 2 and wt == 2:          # TrainerSpec
                for tf, tw, tv in _iter_fields(v):
                    if tf == 3:
                        m.model_type = tv
                    elif tf == 35:
                        m.byte_fallback = bool(tv)
                    elif tf == 40:
                        m.unk_id = _zigzag_signed(tv)
                    elif tf == 41:
                        m.bos_id = _zigzag_signed(tv)
                    elif tf == 42:
                        m.eos_id = _zigzag_signed(tv)
                    elif tf == 43:
                        m.pad_id = _zigzag_signed(tv)
                    elif tf == 45:
                        m.unk_piece = tv.decode("utf-8")
                    elif tf == 44:
                        m.unk_surface = tv.decode("utf-8")
            elif fno == 3 and wt == 2:          # NormalizerSpec
                for nf, nw, nv in _iter_fields(v):
                    if nf == 2 and nw == 2:
                        m.precompiled_charsmap = nv
                    elif nf == 3:
                        m.add_dummy_prefix = bool(nv)
                    elif nf == 4:
                        m.remove_extra_whitespaces = bool(nv)
                    elif nf == 5:
                        m.escape_whitespaces = bool(nv)
        return m


# ------------------------------------------- precompiled charsmap (darts)

class PrecompiledCharsMap:
    """sentencepiece's precompiled normalization table: a darts-clone
    double-array trie over UTF-8 rule prefixes + a NUL-separated pool of
    replacement strings (normalizer.cc DecodePrecompiledCharsMap).

    Blob layout: [uint32le trie_blob_size][trie units][string pool].
    Unit decoding follows darts-clone's DoubleArrayUnit:
      label  = unit & (1<<31 | 0xFF)
      offset = (unit >> 10) << ((unit & (1<<9)) >> 6)
      leaf   = (unit >> 8) & 1;  value unit: unit & 0x7FFFFFFF
    """

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError("charsmap blob too short")
        (trie_size,) = struct.unpack_from("<I", blob, 0)
        if trie_size + 4 > len(blob):
            raise ValueError("charsmap trie size exceeds blob")
        import array

        self.units = array.array("I")
        self.units.frombytes(blob[4 : 4 + trie_size])
        self.pool = blob[4 + trie_size :]

    def longest_match(self, data: bytes, start: int) -> tuple[int, int]:
        """Longest rule prefix of ``data[start:]`` -> (value, length);
        length 0 when no rule matches (darts commonPrefixSearch, keeping
        only the longest hit like Normalizer::NormalizePrefix)."""
        units = self.units
        unit = units[0]
        node_pos = (unit >> 10) << ((unit & 0x200) >> 6)
        best_val, best_len = 0, 0
        for i in range(start, len(data)):
            node_pos ^= data[i]
            if node_pos >= len(units):
                break
            unit = units[node_pos]
            if (unit & 0x800000FF) != data[i]:
                break
            node_pos ^= (unit >> 10) << ((unit & 0x200) >> 6)
            if (unit >> 8) & 1:
                best_val = units[node_pos] & 0x7FFFFFFF
                best_len = i + 1 - start
        return best_val, best_len

    def replacement(self, value: int) -> bytes:
        """NUL-terminated replacement string at pool offset ``value``."""
        end = self.pool.index(b"\0", value)
        return self.pool[value:end]


def build_charsmap(rules: dict[str, str]) -> bytes:
    """Compile prefix-replacement rules into the precompiled-charsmap blob
    format (test-fixture factory: lets charsmap parity tests run without
    the sentencepiece wheel's spm_normalize).  Builds a darts-clone
    double-array by first-fit offset search — fine for rule sets up to a
    few thousand entries."""
    pool = bytearray()
    keyed: dict[bytes, int] = {}
    for src, dst in rules.items():
        keyed[src.encode("utf-8")] = len(pool)
        pool += dst.encode("utf-8") + b"\0"

    units: dict[int, int] = {0: 0}

    def place(node: dict[bytes, int], slot: int) -> None:
        has_leaf = b"" in node
        children: dict[int, dict[bytes, int]] = {}
        for k, v in node.items():
            if k:
                children.setdefault(k[0], {})[k[1:]] = v
        off = 1
        while True:
            base = slot ^ off
            need = [base ^ c for c in children]
            if has_leaf:
                need.append(base)
            if all(s not in units for s in need) and off < (1 << 21):
                break
            off += 1
        assert off < (1 << 21), "offset overflow (tiny-trie builder)"
        units[slot] |= (off << 10) | (int(has_leaf) << 8)
        base = slot ^ off
        if has_leaf:
            units[base] = 0x80000000 | node[b""]
        for c in children:          # claim every sibling slot BEFORE any
            units[base ^ c] = c     # recursion can allocate over it
        for c, sub in children.items():
            place(sub, base ^ c)

    root: dict[bytes, int] = dict(keyed)
    place(root, 0)
    size = max(units) + 1
    # filler label 0xFF + bit31 can never equal an input byte
    arr = [0x800000FF] * size
    for k, v in units.items():
        arr[k] = v
    trie = struct.pack(f"<{size}I", *arr)
    return struct.pack("<I", len(trie)) + trie + bytes(pool)


# ---------------------------------------------------- writer (for tests)

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_len(fno: int, payload: bytes) -> bytes:
    return _varint((fno << 3) | 2) + _varint(len(payload)) + payload


def _field_varint(fno: int, v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    return _varint(fno << 3) + _varint(v)


def build_model_proto(
    pieces: list[tuple[str, float, int]],
    model_type: int = UNIGRAM,
    unk_id: int = 0,
    bos_id: int = 1,
    eos_id: int = 2,
    pad_id: int = -1,
    byte_fallback: bool = False,
    add_dummy_prefix: bool = True,
    remove_extra_whitespaces: bool = True,
    escape_whitespaces: bool = True,
    precompiled_charsmap: bytes = b"",
) -> bytes:
    """Serialize a minimal valid sentencepiece ``.model`` (test fixture
    factory — lets parity tests run without the sentencepiece wheel)."""
    out = bytearray()
    for piece, score, typ in pieces:
        p = _field_len(1, piece.encode("utf-8"))
        p += _varint((2 << 3) | 5) + struct.pack("<f", score)
        p += _field_varint(3, typ)
        out += _field_len(1, p)
    ts = (_field_varint(3, model_type) + _field_varint(35, int(byte_fallback))
          + _field_varint(40, unk_id) + _field_varint(41, bos_id)
          + _field_varint(42, eos_id) + _field_varint(43, pad_id))
    out += _field_len(2, ts)
    ns = (_field_varint(3, int(add_dummy_prefix))
          + _field_varint(4, int(remove_extra_whitespaces))
          + _field_varint(5, int(escape_whitespaces)))
    if precompiled_charsmap:
        ns += _field_len(2, precompiled_charsmap)
    out += _field_len(3, ns)
    return bytes(out)


# ------------------------------------------------------------- processor

class SentencePieceProcessor:
    """Drop-in for the subset of ``sentencepiece.SentencePieceProcessor``
    the reference's tokenizer wrappers call (mmtokenizer.py:71-194)."""

    def __init__(self, model_file: str | None = None,
                 model_proto: bytes | None = None):
        if model_proto is None:
            with open(model_file, "rb") as f:
                model_proto = f.read()
        self.m = SentencePieceModel.parse(model_proto)
        self._charsmap = (PrecompiledCharsMap(self.m.precompiled_charsmap)
                          if self.m.precompiled_charsmap else None)
        self._piece_to_id: dict[str, int] = {}
        self._byte_id: dict[int, int] = {}
        self._matchable: dict[str, tuple[int, float]] = {}
        self._max_piece_chars = 1
        min_score = 0.0
        for i, (piece, score, typ) in enumerate(self.m.pieces):
            if piece not in self._piece_to_id:
                self._piece_to_id[piece] = i
            if typ == BYTE:
                self._byte_id[int(piece[1:-1], 16)] = i
            if typ in (NORMAL, USER_DEFINED):
                if piece not in self._matchable:
                    self._matchable[piece] = (i, score)
                self._max_piece_chars = max(self._max_piece_chars, len(piece))
                min_score = min(min_score, score)
        self._unk_score = min_score - _UNK_PENALTY

    # ---- vocab surface

    def __len__(self) -> int:
        return len(self.m.pieces)

    def get_piece_size(self) -> int:
        return len(self.m.pieces)

    def id_to_piece(self, i: int) -> str:
        if i < 0 or i >= len(self.m.pieces):
            raise IndexError(i)
        return self.m.pieces[i][0]

    def piece_to_id(self, piece: str) -> int:
        return self._piece_to_id.get(piece, self.m.unk_id)

    def unk_id(self) -> int:
        return self.m.unk_id

    def bos_id(self) -> int:
        return self.m.bos_id

    def eos_id(self) -> int:
        return self.m.eos_id

    def pad_id(self) -> int:
        return self.m.pad_id

    # ---- normalize

    def _normalize_prefix(self, data: bytes, i: int) -> tuple[bytes, int]:
        """Normalizer::NormalizePrefix: longest charsmap rule at ``i`` ->
        its replacement; otherwise one UTF-8 char copied through (or
        U+FFFD consuming 1 byte on malformed input)."""
        if self._charsmap is not None:
            val, ln = self._charsmap.longest_match(data, i)
            if ln:
                return self._charsmap.replacement(val), ln
        b0 = data[i]
        if b0 < 0x80:
            n = 1
        elif 0xC2 <= b0 <= 0xDF:
            n = 2
        elif 0xE0 <= b0 <= 0xEF:
            n = 3
        elif 0xF0 <= b0 <= 0xF4:
            n = 4
        else:
            return b"\xef\xbf\xbd", 1
        chunk = data[i : i + n]
        if len(chunk) < n or any((c & 0xC0) != 0x80 for c in chunk[1:]):
            return b"\xef\xbf\xbd", 1
        return chunk, n

    def _normalize(self, text: str) -> str:
        """Normalizer::Normalize, byte-exact: charsmap transduction with
        the heading-skip / dummy-prefix / space-escape / collapse /
        trailing-strip whitespace logic interleaved the way the C++ loop
        does it (normalizer.cc)."""
        data = text.encode("utf-8")
        n = len(data)
        i = 0
        if self.m.remove_extra_whitespaces:        # ignore heading spaces
            while i < n:
                rep, ln = self._normalize_prefix(data, i)
                if rep != b" ":
                    break
                i += ln
        if i >= n:
            return ""
        space = _WS.encode("utf-8") if self.m.escape_whitespaces else b" "
        out = bytearray()
        if self.m.add_dummy_prefix:
            out += space
        is_prev_space = self.m.remove_extra_whitespaces
        while i < n:
            rep, ln = self._normalize_prefix(data, i)
            j = 0
            while is_prev_space and rep[j : j + 1] == b" ":
                j += 1
            sp = rep[j:]
            if sp:
                for byte in sp:
                    if self.m.escape_whitespaces and byte == 0x20:
                        out += space
                    else:
                        out.append(byte)
                is_prev_space = sp.endswith(b" ")
            i += ln
            if not self.m.remove_extra_whitespaces:
                is_prev_space = False
        if self.m.remove_extra_whitespaces:        # ignore trailing spaces
            while out.endswith(space):
                del out[len(out) - len(space):]
        return out.decode("utf-8", errors="replace")

    # ---- encode

    def encode_as_pieces(self, text: str) -> list[str]:
        return [self.m.pieces[i][0] for i in self.encode_as_ids(text)]

    def encode_as_ids(self, text: str) -> list[int]:
        s = self._normalize(text)
        if not s:
            return []
        if self.m.model_type == BPE:
            return self._encode_bpe(s)
        return self._encode_unigram(s)

    encode = encode_as_ids

    def _char_fallback(self, ch: str) -> list[int]:
        if self.m.byte_fallback and self._byte_id:
            return [self._byte_id.get(b, self.m.unk_id)
                    for b in ch.encode("utf-8")]
        return [self.m.unk_id]

    def _encode_unigram(self, s: str) -> list[int]:
        n = len(s)
        # Viterbi over char positions: best[i] = (score, backptr, id|None)
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: list[tuple[int, int | None]] = [(0, None)] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == NEG:
                continue
            hi = min(n, i + self._max_piece_chars)
            for j in range(i + 1, hi + 1):
                sub = s[i:j]
                hit = self._matchable.get(sub)
                if hit is not None:
                    sc = best[i] + hit[1]
                    if sc > best[j]:
                        best[j] = sc
                        back[j] = (i, hit[0])
            # unknown single char edge
            sc = best[i] + self._unk_score
            if sc > best[i + 1]:
                best[i + 1] = sc
                back[i + 1] = (i, None)
        ids: list[int] = []
        j = n
        rev: list[tuple[int, int | None]] = []
        while j > 0:
            i, pid = back[j]
            rev.append((j, pid))
            j = i
        for j, pid in reversed(rev):
            if pid is None:
                ids.extend(self._char_fallback(s[j - 1]))
            else:
                ids.append(pid)
        return ids

    def _encode_bpe(self, s: str) -> list[int]:
        syms = list(s)
        while len(syms) > 1:
            best_score, best_i = None, -1
            for i in range(len(syms) - 1):
                hit = self._matchable.get(syms[i] + syms[i + 1])
                if hit is not None and (best_score is None
                                        or hit[1] > best_score):
                    best_score, best_i = hit[1], i
            if best_i < 0:
                break
            syms[best_i : best_i + 2] = [syms[best_i] + syms[best_i + 1]]
        ids: list[int] = []
        for sym in syms:
            hit = self._matchable.get(sym)
            if hit is not None:
                ids.append(hit[0])
            elif len(sym) == 1:
                ids.extend(self._char_fallback(sym))
            else:  # unmergeable multi-char symbol: per char
                for ch in sym:
                    h = self._matchable.get(ch)
                    ids.extend([h[0]] if h else self._char_fallback(ch))
        return ids

    # ---- decode

    def decode_ids(self, ids) -> str:
        out: list[str] = []
        byte_buf = bytearray()

        def flush_bytes():
            if byte_buf:
                out.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            piece, _, typ = self.m.pieces[int(i)]
            if typ == BYTE:
                byte_buf.append(int(piece[1:-1], 16))
                continue
            flush_bytes()
            if typ == CONTROL:
                continue
            if typ == UNKNOWN:
                out.append(self.m.unk_surface)
                continue
            out.append(piece)
        flush_bytes()
        text = "".join(out).replace(_WS, " ")
        if self.m.add_dummy_prefix and text.startswith(" "):
            text = text[1:]
        return text

    decode = decode_ids
