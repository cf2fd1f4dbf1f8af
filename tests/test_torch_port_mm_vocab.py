"""The port's mm-tokenizer v0.2 module (audiolab_tpu_torch/models/mm_vocab.py,
a copy of the JAX package's framework-free module on the port's own
SentencePiece reader) against the JAX package's, on the CPU.

The tokenizer files are written by the test with each package's
``build_model_proto`` (the two files byte-equal): a small unigram model
without the mm control pieces, where the wrapper appends them in
upstream's order, and with them, where it reuses the file's ids.  Ids,
special ids, the vocabulary and detokenized text must be identical;
``MMCodecTool``'s maps must be equal on random frames of every codec type.
"""

import numpy as np
import pytest

from audiolab_tpu.models import mm_vocab as J
from audiolab_tpu.utils import spm as JS
from audiolab_tpu_torch.models import mm_vocab as T
from audiolab_tpu_torch.utils import spm as TS
from tests.torch_port_tiny import one_torch_thread  # noqa: F401 (autouse)

NORMAL, UNKNOWN, CONTROL = 1, 2, 3
LYRICS = [
    "the fire in the verse",
    "[verse]\nthe fire of the fire\n[chorus]\nin in in",
    "Generate music from the given lyrics segment by segment.\n[Genre] pop rock\nthe fire",
    "a <SOA> b <EOA> c <stage_1> d <stage_2> e",
    "<SOA><EOA><s_local>x<e_global>",
    "[start_of_segment] la la [end_of_reference]",
    "",
    "plain text, no specials!",
]
SPECIAL_NAMES = ("cls", "sep", "eod", "mask", "soa", "eoa", "sov", "eov", "soi", "eoi",
                 "s_local", "e_local", "s_global", "e_global", "stage_1", "stage_2",
                 "pad", "bos", "eos")


def pieces(with_specials: bool) -> list:
    out = [("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL), ("</s>", 0.0, CONTROL),
           ("▁", -2.0, NORMAL), ("▁the", -3.0, NORMAL), ("▁fire", -4.0, NORMAL),
           ("▁in", -3.2, NORMAL), ("▁verse", -4.2, NORMAL), ("▁of", -3.1, NORMAL),
           ("[", -7.0, NORMAL), ("]", -7.0, NORMAL)]
    out += [(ch, -8.5, NORMAL) for ch in "ABCDEFGHIJKLMNOPQRSTUVWXYZ"]
    out += [(ch, -8.0, NORMAL) for ch in "abcdefghijklmnopqrstuvwxyz0123456789.,!?'\n_"]
    if with_specials:
        out += [(tok, 0.0, CONTROL) for tok in T.MM_SPECIAL_TOKENS]
    return out


@pytest.fixture(params=[False, True], ids=["appended", "in_file"])
def tokenizers(request, tmp_path):
    files = []
    for mod in (JS, TS):
        path = tmp_path / f"{mod.__name__.split('.')[0]}.model"
        path.write_bytes(mod.build_model_proto(pieces(request.param), model_type=mod.UNIGRAM))
        files.append(path)
    assert files[0].read_bytes() == files[1].read_bytes()
    return (J.MMTokenizer(model_file=str(files[0])), T.MMTokenizer(model_file=str(files[1])),
            request.param)


def test_mmtokenizer_matches_jax(tokenizers):
    j, t, in_file = tokenizers
    assert t.vocab_size == j.vocab_size and t.vocab == j.vocab and t.inv_vocab == j.inv_vocab
    for name in SPECIAL_NAMES:
        assert getattr(t, name) == getattr(j, name), name
    n_pieces = len(t.sp)
    if in_file:
        # the file's control pieces keep their ids; CLS, SEP, MASK, PAD appended
        assert t.soa == t.sp.piece_to_id("<SOA>") and t.vocab_size == n_pieces + 4
    else:
        # upstream's order from the end of the file: CLS, SEP, EOD, MASK, SOA, ...
        assert (t.cls, t.sep, t.eod, t.mask, t.soa) == tuple(range(n_pieces, n_pieces + 5))
    for text in LYRICS:
        ids = t.tokenize(text)
        assert ids == j.tokenize(text), text
        assert t.detokenize(ids) == j.detokenize(ids), text
    # specials split first, the earliest match winning
    ids = t.tokenize("x<SOA>y<EOA>")
    assert t.soa in ids and t.eoa in ids and ids.index(t.soa) < ids.index(t.eoa)


def test_mm_constants_are_the_jax_tables():
    assert T.MM_SPECIAL_TOKENS == J.MM_SPECIAL_TOKENS
    assert T.MM_CODEC_CFG == J.MM_CODEC_CFG
    assert T.MM_VOCAB_LEN == J.MM_VOCAB_LEN == 83734


@pytest.mark.parametrize("codec_type", sorted(J.MM_CODEC_CFG))
def test_codec_tool_matches_jax(codec_type):
    """offset / unoffset / flatten / unflatten / npy2ids / ids2npy for every
    codec type, over all its codebooks and over a slice of them."""
    cfg = J.MM_CODEC_CFG[codec_type]
    k = cfg["num_codebooks"]
    rng = np.random.default_rng(len(codec_type))
    codes = rng.integers(0, cfg["codebook_size"], (k, 23)).astype(np.int64)
    for begin, nq in ((0, None), (k // 2, k - k // 2)):
        j, t = (M.MMCodecTool(codec_type, begin, nq) for M in (J, T))
        assert (t.codebook_size, t.num_codebooks, t.global_offset, t.sep_ids, t.n_quantizer) == (
            j.codebook_size, j.num_codebooks, j.global_offset, j.sep_ids, j.n_quantizer)
        off = t.offset_tok_ids(codes)
        np.testing.assert_array_equal(off, j.offset_tok_ids(codes))
        flat = t.flatten(off)
        np.testing.assert_array_equal(flat, j.flatten(off))
        np.testing.assert_array_equal(t.unflatten(flat, t.n_quantizer),
                                      j.unflatten(flat, j.n_quantizer))
        np.testing.assert_array_equal(t.unoffset_tok_ids(off), j.unoffset_tok_ids(off))
        assert t.npy2ids(codes) == j.npy2ids(codes)
        np.testing.assert_array_equal(t.ids2npy(flat), j.ids2npy(flat))
        np.testing.assert_array_equal(t.ids2npy(flat), codes[begin:begin + t.n_quantizer])
