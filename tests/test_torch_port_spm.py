"""The port's SentencePiece reader (audiolab_tpu_torch/utils/spm.py, a copy of
the JAX package's framework-free module) against the JAX package's, on
model files the test writes with each package's ``build_model_proto``:
UNIGRAM and BPE, byte fallback, a precompiled charsmap, T5's id layout.
Ids, pieces and decoded text must be identical."""

import pytest

from audiolab_tpu.utils import spm as J
from audiolab_tpu_torch.utils import spm as T
from tests.torch_port_tiny import one_torch_thread  # noqa: F401 (autouse)

NORMAL, UNKNOWN, CONTROL, BYTE = 1, 2, 3, 6
TEXTS = ["a b", "ab ba  aab", "  leading and trailing  ", "café ＡＢ", "",
         "b" * 40, "x y z ▁", "mixed abé ba"]
BASE = [("<pad>", 0.0, CONTROL), ("</s>", 0.0, CONTROL), ("<unk>", 0.0, UNKNOWN),
        ("▁", -2.0, NORMAL), ("▁a", -1.0, NORMAL), ("▁b", -1.5, NORMAL),
        ("a", -2.5, NORMAL), ("b", -2.5, NORMAL), ("ab", -1.2, NORMAL), ("ba", -1.3, NORMAL),
        ("▁ab", -0.9, NORMAL), ("e", -3.0, NORMAL), ("A", -3.0, NORMAL),
        ("B", -3.0, NORMAL)]
BYTES = [(f"<0x{i:02X}>", 0.0, BYTE) for i in range(256)]
CASES = {
    "unigram": dict(pieces=BASE, model_type=J.UNIGRAM),
    "bpe": dict(pieces=BASE, model_type=J.BPE),
    "unigram_bytes": dict(pieces=BASE + BYTES, model_type=J.UNIGRAM, byte_fallback=True),
    "bpe_bytes": dict(pieces=BASE + BYTES, model_type=J.BPE, byte_fallback=True),
    "charsmap": dict(pieces=BASE, model_type=J.UNIGRAM,
                     charsmap={"Ａ": "A", "Ｂ": "B", "é": "e"}),
    "no_dummy_prefix": dict(pieces=BASE, model_type=J.UNIGRAM, add_dummy_prefix=False),
}


@pytest.fixture(params=sorted(CASES))
def processors(request, tmp_path):
    """(JAX processor, port processor) reading the model file each package's
    ``build_model_proto`` writes for the case (the two files byte-equal)."""
    kw = dict(CASES[request.param])
    rules = kw.pop("charsmap", None)
    files = []
    for mod in (J, T):
        extra = {"precompiled_charsmap": mod.build_charsmap(rules)} if rules else {}
        blob = mod.build_model_proto(kw["pieces"], model_type=kw["model_type"], unk_id=2,
                                     bos_id=-1, eos_id=1, pad_id=0,
                                     byte_fallback=kw.get("byte_fallback", False),
                                     add_dummy_prefix=kw.get("add_dummy_prefix", True),
                                     **extra)
        path = tmp_path / f"{mod.__name__.split('.')[0]}.model"
        path.write_bytes(blob)
        files.append(path)
    assert files[0].read_bytes() == files[1].read_bytes()
    return J.SentencePieceProcessor(str(files[0])), T.SentencePieceProcessor(str(files[1]))


def test_ids_pieces_and_decode_match_jax(processors):
    j, t = processors
    assert len(t) == len(j)
    assert (t.unk_id(), t.bos_id(), t.eos_id(), t.pad_id()) == (
        j.unk_id(), j.bos_id(), j.eos_id(), j.pad_id())
    for text in TEXTS:
        ids = t.encode_as_ids(text)
        assert ids == j.encode_as_ids(text), text
        assert t.encode_as_pieces(text) == j.encode_as_pieces(text), text
        assert t.decode_ids(ids) == j.decode_ids(ids), text
    assert [t.id_to_piece(i) for i in range(len(t))] == [j.id_to_piece(i) for i in range(len(j))]


def test_t5_prompt_tokenizer_matches_jax(tmp_path):
    """T5Conditioner packing through both packages' ``T5PromptTokenizer``:
    cut to max_length - 1, ``</s>``, pad 0, the mask."""
    from audiolab_tpu.pipelines.music import T5PromptTokenizer as JTok
    from audiolab_tpu_torch.pipelines.music import T5PromptTokenizer as TTok

    path = tmp_path / "t5.model"
    path.write_bytes(T.build_model_proto(BASE, model_type=T.UNIGRAM, unk_id=2, bos_id=-1,
                                         eos_id=1, pad_id=0))
    texts = ["a b", "a a a a a a a a a", "ba ab", ""]
    got, want = TTok(str(path), max_length=6)(texts), JTok(str(path), max_length=6)(texts)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and (g == w).all()
    assert got[0][0, :3].tolist() == [4, 5, 1] and got[1][1].sum() == 6
