"""YuE mm-tokenizer v0.2 vocabulary: tokenizer wrapper + codec-id layout (a
copy of audiolab_tpu/models/mm_vocab.py, which imports no framework: the
port keeps its own copy, on its own ``utils/spm.py``).

Two upstream pieces are reproduced checkpoint-compatibly:

* ``MMTokenizer`` — the Megatron-style sentencepiece wrapper the YuE
  LMs were trained with (modules/yue/inference/mmtokenizer.py:238
  ``_MMSentencePieceTokenizer``): base sentencepiece vocab + special
  tokens appended IN A FIXED ORDER when absent from the model file
  (<CLS> <SEP> <EOD> <MASK> <SOA> <EOA> <SOV> <EOV> <SOI> <EOI>
  <s_local> <e_local> <s_global> <e_global> <stage_1> <stage_2> then
  pad/bos/eos), special-token-aware tokenize/detokenize.  Runs on the
  pure-Python sentencepiece (utils/spm.py), so the real
  ``mm_tokenizer_v0.2_hf/tokenizer.model`` loads without the wheel.

* ``MMCodecTool`` — the flat-token <-> codec-frame maps of
  modules/yue/inference/codecmanipulator.py:28-57 (mm_v0_2 table):
  per-codec global offsets into the LM vocab, offset/unoffset,
  time-major flatten/unflatten.  Vectorized numpy instead of the
  reference's per-codebook loops.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# mm_v0_2 special-token ids (codecmanipulator.py:36-38) — these are the
# ids the PUBLISHED tokenizer.model carries for its control pieces; the
# MMTokenizer below derives the same values from the model file itself.
MM_SPECIAL_TOKENS: dict[str, int] = {
    "<EOD>": 32000, "<SOA>": 32001, "<EOA>": 32002, "<SOI>": 32003,
    "<EOI>": 32004, "<SOV>": 32005, "<EOV>": 32006, "<s_local>": 32007,
    "<e_local>": 32008, "<s_global>": 32009, "<e_global>": 32010,
    "<semantic>": 32011, "<acoustic>": 32012, "<stage_1>": 32013,
    "<dac_16k>": 32014, "<dac_44k>": 32015, "<xcodec>": 32016,
    "<stage_2>": 32017, "<semantic_mert>": 32018,
    "<semantic_hubert>": 32019, "<visual>": 32020, "<semanticodec>": 32021,
}

# per-codec layout (codecmanipulator.py:29-35): codebook_size,
# num_codebooks, global_offset, separator special tokens
MM_CODEC_CFG: dict[str, dict] = {
    "dac16k": {"codebook_size": 1024, "num_codebooks": 4,
               "global_offset": 32022, "sep": ["<dac_16k>"], "fps": 50},
    "dac44k": {"codebook_size": 1024, "num_codebooks": 9,
               "global_offset": 36118, "sep": ["<dac_44k>"]},
    "xcodec": {"codebook_size": 1024, "num_codebooks": 12,
               "global_offset": 45334, "sep": ["<xcodec>"], "fps": 50},
    "mert": {"codebook_size": 1024, "num_codebooks": 1,
             "global_offset": 57622, "sep": ["<semantic_mert>"]},
    "hubert": {"codebook_size": 512, "num_codebooks": 1,
               "global_offset": 58646, "sep": ["<semantic_hubert>"]},
    "semantic/s": {"codebook_size": 16384, "num_codebooks": 1,
                   "global_offset": 59158,
                   "sep": ["<semanticodec>", "<semantic>"]},
    "semantic/a": {"codebook_size": 8192, "num_codebooks": 1,
                   "global_offset": 75542,
                   "sep": ["<semanticodec>", "<acoustic>"]},
}

MM_VOCAB_LEN = 83734  # metadata.len (codecmanipulator.py:40)


@dataclass
class MMCodecTool:
    """CodecManipulator equivalent: (K, T) codec frames <-> flat LM ids."""

    codec_type: str = "xcodec"
    quantizer_begin: int = 0
    n_quantizer: int | None = None

    def __post_init__(self):
        cfg = MM_CODEC_CFG[self.codec_type]
        self.codebook_size: int = cfg["codebook_size"]
        self.num_codebooks: int = cfg["num_codebooks"]
        self.global_offset: int = cfg["global_offset"]
        self.sep_ids: list[int] = [MM_SPECIAL_TOKENS[s] for s in cfg["sep"]]
        if self.n_quantizer is None:
            self.n_quantizer = self.num_codebooks

    def _offsets(self) -> np.ndarray:
        k = np.arange(self.quantizer_begin,
                      self.quantizer_begin + self.n_quantizer)
        return (self.global_offset + k * self.codebook_size)[:, None]

    def offset_tok_ids(self, x: np.ndarray) -> np.ndarray:
        """(K, T) raw codes -> (K, T) LM ids (offset_tok_ids :71-98)."""
        x = np.asarray(x)
        assert x.max() < self.codebook_size and x.min() >= 0
        return (x[self.quantizer_begin : self.quantizer_begin
                  + self.n_quantizer].astype(np.int64) + self._offsets())

    def unoffset_tok_ids(self, x: np.ndarray) -> np.ndarray:
        """(K, T) LM ids -> (K, T) raw codes (unoffset_tok_ids :100-125)."""
        return np.asarray(x, np.int64) - self._offsets()

    def flatten(self, x: np.ndarray) -> np.ndarray:
        """(K, T) -> (T*K,) time-major (flatten :127-132)."""
        return np.asarray(x).T.reshape(-1)

    def unflatten(self, x: np.ndarray, n_quantizer: int | None = None):
        """(T*K,) -> (K, T) (unflatten :134-141)."""
        k = n_quantizer or self.num_codebooks
        return np.asarray(x).reshape(-1, k).T

    def npy2ids(self, codes: np.ndarray) -> list[int]:
        """(K, T) raw codes -> flat LM id list (npy2ids :158-175)."""
        return self.flatten(self.offset_tok_ids(codes)).tolist()

    def ids2npy(self, ids: np.ndarray) -> np.ndarray:
        """flat LM ids -> (K, T) raw codes (ids2npy)."""
        return self.unoffset_tok_ids(self.unflatten(ids, self.n_quantizer))


# the order _MMSentencePieceTokenizer._initalize appends missing specials
# (mmtokenizer.py:259-291)
_MM_APPEND_ORDER = (
    "<CLS>", "<SEP>", "<EOD>", "<MASK>", "<SOA>", "<EOA>", "<SOV>", "<EOV>",
    "<SOI>", "<EOI>", "<s_local>", "<e_local>", "<s_global>", "<e_global>",
    "<stage_1>", "<stage_2>",
)


class MMTokenizer:
    """_MMSentencePieceTokenizer-compatible wrapper (mmtokenizer.py:238)
    over utils/spm.SentencePieceProcessor.

    Vocabulary = base sentencepiece pieces, then any of the 16 control
    tokens not already present appended in upstream's fixed order, then
    pad/bos/eos resolved through the model's ids (appended as
    <PAD>/<BOS>/<EOS> when the model has none).  ``tokenize`` splits on
    special-token SURFACE STRINGS first (earliest match wins) and
    sentencepiece-encodes the text between them; ``detokenize`` is the
    inverse with single-space joins — byte-exact with upstream's
    NeMo-derived loops (mmtokenizer.py:158-195).
    """

    def __init__(self, model_file: str | None = None,
                 model_proto: bytes | None = None, sp=None):
        from audiolab_tpu_torch.utils.spm import SentencePieceProcessor

        self.sp = sp or SentencePieceProcessor(model_file=model_file,
                                               model_proto=model_proto)
        self._vocab: dict[str, int] = {}
        self._inv_vocab: dict[int, str] = {}
        for i in range(len(self.sp)):
            t = self.sp.id_to_piece(i)
            self._inv_vocab[i] = t
            self._vocab[t] = i
        self._special: dict[str, int] = {}
        self._inv_special: dict[int, str] = {}

        def add(tok: str) -> int:
            if tok not in self._vocab:
                nid = len(self._vocab)
                self._vocab[tok] = nid
                self._inv_vocab[nid] = tok
            self._special[tok] = self._vocab[tok]
            self._inv_special[self._vocab[tok]] = tok
            return self._vocab[tok]

        ids = [add(t) for t in _MM_APPEND_ORDER]
        (self.cls, self.sep, self.eod, self.mask, self.soa, self.eoa,
         self.sov, self.eov, self.soi, self.eoi, self.s_local, self.e_local,
         self.s_global, self.e_global, self.stage_1, self.stage_2) = ids

        def resolved(model_id: int, fallback: str) -> int:
            try:
                tok = self.sp.id_to_piece(model_id)
            except IndexError:
                tok = fallback
            return add(tok)

        self.pad = resolved(self.sp.pad_id(), "<PAD>")
        self.bos = resolved(self.sp.bos_id(), "<BOS>")
        self.eos = resolved(self.sp.eos_id(), "<EOS>")

    @property
    def vocab_size(self) -> int:
        return len(self._vocab)

    @property
    def vocab(self) -> dict[str, int]:
        return self._vocab

    @property
    def inv_vocab(self) -> dict[int, str]:
        return self._inv_vocab

    def tokenize(self, text: str) -> list[int]:
        ids: list[int] = []
        idx = 0
        while True:
            hits = {t: text.index(t, idx) for t in self._special
                    if t in text[idx:]}
            if not hits:
                break
            tok = min(hits, key=hits.get)
            at = hits[tok]
            ids.extend(self.sp.encode_as_ids(text[idx:at]))
            ids.append(self._special[tok])
            idx = at + len(tok)
        ids.extend(self.sp.encode_as_ids(text[idx:]))
        return ids

    def detokenize(self, ids: list[int]) -> str:
        text = ""
        last = 0
        for i, tid in enumerate(ids):
            if tid in self._inv_special:
                text += self.sp.decode_ids(ids[last:i]) + " "
                text += self._inv_special[tid] + " "
                last = i + 1
        return text + self.sp.decode_ids(ids[last:])
