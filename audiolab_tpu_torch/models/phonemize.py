"""Rule-based English grapheme-to-phoneme front-end (a copy of
audiolab_tpu/models/phonemize.py: framework-free numpy, kept apart so
that the port imports nothing of the JAX package).

Stand-in for libespeak-ng (reference: modules/zonos/conditioning.py:180-207
phonemizes text before the Zonos conditioner; libs/libespeak-ng.dll).  A
compact letter-to-sound ruleset produces ARPAbet-like tokens — far closer
to espeak's output distribution than raw characters, and the conditioner
interface is unchanged (ids < 256).  Swap in espeak via ctypes when the
library is present.

Three tiers, mirroring how espeak resolves a word (dictionary, then
letter-to-sound rules): (1) an exceptions lexicon with the highest-frequency
irregular English words — function words alone cover roughly half of running
text; (2) voicing-aware suffix handling (-ed -> D/T/IH D, -s/-es ->
Z/S/IH Z, -tion/-ture/-ous/...); (3) ordered letter-to-sound rules with
magic-e, soft c/g, silent letters and doubled-consonant collapse.  Falls
back to letter sounds for anything else.
"""

from __future__ import annotations

import re

import numpy as np

# phoneme inventory (ARPAbet-ish), each mapped to a stable id
PHONEMES = [
    "sil", "AA", "AE", "AH", "AO", "AW", "AY", "B", "CH", "D", "DH", "EH",
    "ER", "EY", "F", "G", "HH", "IH", "IY", "JH", "K", "L", "M", "N", "NG",
    "OW", "OY", "P", "R", "S", "SH", "T", "TH", "UH", "UW", "V", "W", "Y",
    "Z", "ZH",
]
PHONE_ID = {p: i + 1 for i, p in enumerate(PHONEMES)}  # 0 = pad

# exceptions lexicon: highest-frequency irregular words (CMUdict-style
# ARPAbet, stress dropped).  espeak resolves these from its dictionary
# before its letter-to-sound rules; the top ~150 function/irregular words
# cover ~half of running English text.
_LEXICON: dict[str, list[str]] = {w: p.split() for w, p in {
    "the": "DH AH", "of": "AH V", "to": "T UW", "a": "AH", "and": "AE N D",
    "is": "IH Z", "was": "W AH Z", "are": "AA R", "were": "W ER",
    "be": "B IY", "been": "B IH N", "as": "AE Z", "his": "HH IH Z",
    "has": "HH AE Z", "have": "HH AE V", "had": "HH AE D",
    "he": "HH IY", "she": "SH IY", "we": "W IY", "me": "M IY",
    "they": "DH EY", "them": "DH EH M", "their": "DH EH R",
    "there": "DH EH R", "these": "DH IY Z", "those": "DH OW Z",
    "this": "DH IH S", "that": "DH AE T", "then": "DH EH N",
    "than": "DH AE N", "thus": "DH AH S", "though": "DH OW",
    "through": "TH R UW", "thought": "TH AO T", "three": "TH R IY",
    "with": "W IH DH", "what": "W AH T", "who": "HH UW",
    "whom": "HH UW M", "whose": "HH UW Z", "why": "W AY",
    "where": "W EH R", "when": "W EH N", "which": "W IH CH",
    "one": "W AH N", "once": "W AH N S", "two": "T UW", "four": "F AO R",
    "eight": "EY T", "do": "D UW", "does": "D AH Z", "done": "D AH N",
    "don't": "D OW N T", "been": "B IH N", "said": "S EH D",
    "says": "S EH Z", "would": "W UH D", "could": "K UH D",
    "should": "SH UH D", "you": "Y UW", "your": "Y AO R", "i": "AY",
    "my": "M AY", "by": "B AY", "any": "EH N IY", "many": "M EH N IY",
    "some": "S AH M", "come": "K AH M", "son": "S AH N",
    "from": "F R AH M", "front": "F R AH N T", "month": "M AH N TH",
    "other": "AH DH ER", "mother": "M AH DH ER", "brother": "B R AH DH ER",
    "father": "F AA DH ER", "another": "AH N AH DH ER",
    "love": "L AH V", "above": "AH B AH V", "give": "G IH V",
    "live": "L IH V", "gone": "G AO N", "only": "OW N L IY",
    "people": "P IY P AH L", "water": "W AO T ER", "again": "AH G EH N",
    "against": "AH G EH N S T", "great": "G R EY T", "break": "B R EY K",
    "pretty": "P R IH T IY", "busy": "B IH Z IY", "very": "V EH R IY",
    "every": "EH V R IY", "eye": "AY", "eyes": "AY Z",
    "woman": "W UH M AH N", "women": "W IH M AH N", "world": "W ER L D",
    "word": "W ER D", "work": "W ER K", "worse": "W ER S",
    "hour": "AW ER", "honest": "AA N AH S T", "honor": "AA N ER",
    "heart": "HH AA R T", "iron": "AY ER N", "island": "AY L AH N D",
    "enough": "IH N AH F", "rough": "R AH F", "tough": "T AH F",
    "laugh": "L AE F", "cough": "K AO F", "because": "B IH K AO Z",
    "want": "W AA N T", "watch": "W AA CH", "was": "W AH Z",
    "put": "P UH T", "push": "P UH SH", "pull": "P UH L",
    "full": "F UH L", "sure": "SH UH R", "sugar": "SH UH G ER",
    "move": "M UW V", "prove": "P R UW V", "lose": "L UW Z",
    "whole": "HH OW L", "own": "OW N", "most": "M OW S T",
    "both": "B OW TH", "old": "OW L D", "cold": "K OW L D",
    "find": "F AY N D", "kind": "K AY N D", "mind": "M AY N D",
    "wild": "W AY L D", "child": "CH AY L D", "climb": "K L AY M",
    "comb": "K OW M", "lamb": "L AE M", "thumb": "TH AH M",
    "debt": "D EH T", "doubt": "D AW T", "listen": "L IH S AH N",
    "often": "AO F AH N", "castle": "K AE S AH L",
    "answer": "AE N S ER", "sword": "S AO R D", "two": "T UW",
    "friend": "F R EH N D", "earth": "ER TH", "early": "ER L IY",
    "learn": "L ER N", "heard": "HH ER D", "year": "Y IH R",
    "here": "HH IH R", "there": "DH EH R", "they're": "DH EH R",
    "you're": "Y UH R", "it's": "IH T S", "its": "IH T S",
    "music": "M Y UW Z IH K", "use": "Y UW Z", "used": "Y UW Z D",
    "usual": "Y UW ZH UW AH L", "human": "HH Y UW M AH N",
    "beautiful": "B Y UW T AH F AH L", "future": "F Y UW CH ER",
    "new": "N UW", "few": "F Y UW", "view": "V Y UW",
    "voice": "V OY S", "noise": "N OY Z", "good": "G UH D",
    "book": "B UH K", "look": "L UH K", "took": "T UH K",
    "foot": "F UH T", "stood": "S T UH D", "blood": "B L AH D",
    "flood": "F L AH D", "door": "D AO R", "floor": "F L AO R",
    "idea": "AY D IY AH", "area": "EH R IY AH", "real": "R IY L",
    "really": "R IH L IY", "being": "B IY IH NG", "busy": "B IH Z IY",
    "minute": "M IH N AH T", "says": "S EH Z", "ocean": "OW SH AH N",
    "machine": "M AH SH IY N", "special": "S P EH SH AH L",
    "social": "S OW SH AH L", "sun": "S AH N", "son": "S AH N",
}.items()}

# ordered digraph/trigraph rules (longest first)
_RULES = [
    ("tch", ["CH"]), ("eigh", ["EY"]), ("igh", ["AY"]), ("ough", ["AO"]),
    ("augh", ["AO"]), ("dge", ["JH"]),
    ("tion", ["SH", "AH", "N"]), ("sion", ["ZH", "AH", "N"]),
    ("cious", ["SH", "AH", "S"]), ("tious", ["SH", "AH", "S"]),
    ("ture", ["CH", "ER"]), ("sure", ["ZH", "ER"]),
    ("ing", ["IH", "NG"]), ("qu", ["K", "W"]),
    ("ch", ["CH"]), ("sh", ["SH"]), ("th", ["TH"]), ("ph", ["F"]),
    ("wh", ["W"]), ("ck", ["K"]), ("ng", ["NG"]), ("kn", ["N"]),
    ("wr", ["R"]), ("gn", ["N"]), ("mb", ["M"]),
    ("oo", ["UW"]), ("ee", ["IY"]), ("ea", ["IY"]),
    ("ai", ["EY"]), ("ay", ["EY"]), ("oa", ["OW"]), ("ow", ["OW"]),
    ("ou", ["AW"]), ("oi", ["OY"]), ("oy", ["OY"]), ("au", ["AO"]),
    ("aw", ["AO"]), ("ew", ["UW"]), ("ue", ["UW"]), ("ui", ["UW"]),
    ("ie", ["IY"]), ("ei", ["IY"]),
    ("ar", ["AA", "R"]), ("er", ["ER"]), ("ir", ["ER"]),
    ("ur", ["ER"]), ("or", ["AO", "R"]), ("ore", ["AO", "R"]),
    ("air", ["EH", "R"]), ("ear", ["IH", "R"]),
]

_VOICELESS = {"P", "T", "K", "F", "TH", "S", "SH", "CH", "HH"}
_SIBILANT = {"S", "Z", "SH", "ZH", "CH", "JH"}

_LETTER = {
    "a": ["AE"], "b": ["B"], "c": ["K"], "d": ["D"], "e": ["EH"],
    "f": ["F"], "g": ["G"], "h": ["HH"], "i": ["IH"], "j": ["JH"],
    "k": ["K"], "l": ["L"], "m": ["M"], "n": ["N"], "o": ["AA"],
    "p": ["P"], "q": ["K"], "r": ["R"], "s": ["S"], "t": ["T"],
    "u": ["AH"], "v": ["V"], "w": ["W"], "x": ["K", "S"], "y": ["Y"],
    "z": ["Z"],
}

_LONG_VOWEL = {"a": "EY", "e": "IY", "i": "AY", "o": "OW", "u": "UW"}

_NUM_WORDS = {
    "0": "zero", "1": "one", "2": "two", "3": "three", "4": "four",
    "5": "five", "6": "six", "7": "seven", "8": "eight", "9": "nine",
}


def normalize_text(text: str) -> str:
    """Lowercase, expand digits, strip to pronounceable chars."""
    text = text.lower()
    text = re.sub(r"\d", lambda m: " " + _NUM_WORDS[m.group()] + " ", text)
    text = re.sub(r"[^a-z\s'.,!?-]", " ", text)
    return " ".join(text.split())


def _letter_to_sound(word: str) -> list[str]:
    """Tier-3 ordered letter-to-sound pass over one (suffix-stripped) word."""
    # derivational endings that the magic-e rule would otherwise mangle
    if len(word) > 4 and word.endswith(("ture", "sure")):
        stem = _letter_to_sound(word[:-4])
        # open-syllable stem vowel goes long ("na|ture" -> N EY CH ER)
        if (stem and word[-5] in _LONG_VOWEL
                and stem[-1] == _LETTER[word[-5]][0]):
            stem[-1] = _LONG_VOWEL[word[-5]]
        return stem + (["CH", "ER"] if word.endswith("ture")
                       else ["ZH", "ER"])
    if len(word) > 3 and word.endswith("le") and word[-3] not in "aeiouy":
        # syllabic -le: single consonant = open syllable, long vowel
        # ("ta|ble", "ti|tle"); doubled consonant keeps it short ("little")
        stem_w = word[:-2]
        stem = _letter_to_sound(stem_w)
        if (len(stem_w) >= 2 and stem_w[-1] != stem_w[-2]
                and stem_w[-2] in _LONG_VOWEL and len(stem) >= 2
                and stem[-2] == _LETTER[stem_w[-2]][0]):
            stem[-2] = _LONG_VOWEL[stem_w[-2]]
        return stem + ["AH", "L"]
    # collapse doubled consonants (letter -> one sound: "little", "happy")
    word = re.sub(r"([bcdfgklmnprstvz])\1", r"\1", word)
    # magic-e: drop final silent e, lengthen the preceding vowel
    long_vowel_at = None
    if (len(word) >= 3 and word.endswith("e") and word[-2] not in "aeiou"
            and word[-3] in "aeiou"):
        long_vowel_at = len(word) - 3
        word = word[:-1]
    out: list[str] = []
    i = 0
    while i < len(word):
        if i == long_vowel_at and word[i] in _LONG_VOWEL:
            out.append(_LONG_VOWEL[word[i]])
            i += 1
            continue
        for pat, phs in _RULES:
            if word.startswith(pat, i):
                out.extend(phs)
                i += len(pat)
                break
        else:
            ch = word[i]
            if ch == "c" and i + 1 < len(word) and word[i + 1] in "eiy":
                out.append("S")          # soft c
            elif ch == "g" and i + 1 < len(word) and word[i + 1] in "eiy":
                out.append("JH")         # soft g
            elif (ch == "s" and 0 < i < len(word) - 1
                  and word[i - 1] in "aeiou" and word[i + 1] in "aeiou"):
                out.append("Z")          # intervocalic s ("music", "rose")
            elif ch == "y" and i == len(word) - 1 and len(word) > 1:
                out.append("IY")         # final y ("happy")
            elif ch == "y" and 0 < i:
                out.append("IH")         # medial y as vowel ("system")
            else:
                out.extend(_LETTER.get(ch, []))
            i += 1
    return out


def word_to_phonemes(word: str) -> list[str]:
    word = word.strip("'-")
    if not word:
        return []
    if word in _LEXICON:
        return list(_LEXICON[word])

    # voicing-aware inflection suffixes (espeak resolves the stem first):
    # -ed -> IH D after t/d, T after voiceless, D after voiced
    # -s/-es -> IH Z after sibilants, S after voiceless, Z after voiced
    if word.endswith("ed") and len(word) > 3:
        stem_w = word[:-2]
        # "loved"/"hoped": the stem keeps its silent e ("love" + d)
        if stem_w[-1] not in "aeiouy" and len(stem_w) >= 2 \
                and stem_w[-2] in "aeiou":
            stem = word_to_phonemes(stem_w + "e")
        else:
            stem = word_to_phonemes(stem_w)
        if stem:
            if stem[-1] in ("T", "D"):
                return stem + ["IH", "D"]
            return stem + (["T"] if stem[-1] in _VOICELESS else ["D"])
    if word.endswith("s") and not word.endswith("ss") and len(word) > 2:
        # "-es" belongs to the suffix only after sibilant stems
        # ("boxes", "churches"); otherwise strip the bare "s" ("notes").
        # A bare-s stem that's a known lexicon word wins ("uses" -> "use")
        es = (word.endswith("es") and len(word) > 3
              and word[-3] in "sxzh" and word[:-1] not in _LEXICON)
        stem = word_to_phonemes(word[:-2] if es else word[:-1])
        if stem:
            if stem[-1] in _SIBILANT:
                return stem + ["IH", "Z"]
            return stem + (["S"] if stem[-1] in _VOICELESS else ["Z"])
    return _letter_to_sound(word)


def phonemize(text: str) -> list[str]:
    """Text -> phoneme token list with 'sil' at punctuation boundaries."""
    out: list[str] = []
    for tok in normalize_text(text).split():
        bare = tok.strip(".,!?")
        out.extend(word_to_phonemes(bare))
        if tok[-1:] in ".,!?":
            out.append("sil")
    return out


def phonemize_ids(text: str, max_len: int = 256) -> np.ndarray:
    """Text -> int32 phoneme ids (0 = pad), drop-in for tokenize_text."""
    ids = [PHONE_ID[p] for p in phonemize(text)][:max_len]
    return np.asarray(ids, np.int32)


# --------------------------------------------------- espeak IPA surface
#
# The reference phonemizes through the real espeak-ng library
# (modules/zonos/conditioning.py:180-207, EspeakBackend with_stress=True)
# and tokenizes the IPA string char-by-char against the VITS symbol table
# (conditioning.py:25-35).  Three tiers here, best available wins:
#   1. a real espeak binary (espeak-ng/espeak) or libespeak-ng.so found at
#      runtime — exact parity with the reference's front-end;
#   2. the espeak-convention IPA lexicon below (stress marks included);
#   3. the rule G2P above, mapped ARPAbet -> espeak-style IPA glyphs with
#      naive primary stress on the first vowel of content words.
# This image ships neither the espeak binary nor its data files (the
# reference's libs/libespeak-ng.dll is a 460 KB Windows PE with no
# dictionaries), so tier 1 is exercised only where espeak exists;
# tools/gen_espeak_fixture.py regenerates the test fixture from it.

import subprocess as _subprocess

# ARPAbet -> espeak-ng en-us IPA glyphs (espeak uses ɹ, ɚ/ɜː, long marks)
_ARPA_TO_IPA = {
    "AA": "ɑː", "AE": "æ", "AH": "ʌ", "AO": "ɔː", "AW": "aʊ", "AY": "aɪ",
    "B": "b", "CH": "tʃ", "D": "d", "DH": "ð", "EH": "ɛ", "ER": "ɜː",
    "EY": "eɪ", "F": "f", "G": "ɡ", "HH": "h", "IH": "ɪ", "IY": "iː",
    "JH": "dʒ", "K": "k", "L": "l", "M": "m", "N": "n", "NG": "ŋ",
    "OW": "oʊ", "OY": "ɔɪ", "P": "p", "R": "ɹ", "S": "s", "SH": "ʃ",
    "T": "t", "TH": "θ", "UH": "ʊ", "UW": "uː", "V": "v", "W": "w",
    "Y": "j", "Z": "z", "ZH": "ʒ",
}
_IPA_VOWELS = set("ɑæʌɔaəɐɛɜeɪiːoʊuʊɚɝ")

# espeak-ng en-us conventions for high-frequency words (stress placed
# directly before the stressed VOWEL, espeak's IPA layout; ɐ for reduced
# a, ɾ for flapped t, ɚ for unstressed r-colored schwa).  Regenerate
# against a real espeak with tools/gen_espeak_fixture.py; entries match
# the phonemizer project's published espeak examples where available
# ("hello world" -> "həlˈoʊ wˈɜːld", "this is a test" -> "ðɪs ɪz ɐ tˈɛst").
_IPA_LEXICON: dict[str, str] = {
    "the": "ðə", "a": "ɐ", "an": "ɐn", "and": "ænd", "of": "ʌv",
    "to": "tuː", "in": "ɪn", "is": "ɪz", "it": "ɪt", "you": "juː",
    "that": "ðæt", "this": "ðɪs", "he": "hiː", "she": "ʃiː", "we": "wiː",
    "they": "ðeɪ", "was": "wʌz", "are": "ɑːɹ", "for": "fɔːɹ", "as": "æz",
    "with": "wɪð", "his": "hɪz", "be": "biː", "at": "æt", "by": "baɪ",
    "not": "nˈɑːt", "but": "bˈʌt", "from": "fɹʌm", "or": "ɔːɹ",
    "have": "hæv", "had": "hæd", "has": "hæz", "what": "wˈʌt",
    "one": "wˈʌn", "two": "tˈuː", "three": "θɹˈiː", "four": "fˈoːɹ",
    "five": "fˈaɪv", "six": "sˈɪks", "seven": "sˈɛvən", "eight": "ˈeɪt",
    "nine": "nˈaɪn", "ten": "tˈɛn", "zero": "zˈiəɹoʊ",
    "hello": "həlˈoʊ", "world": "wˈɜːld", "test": "tˈɛst",
    "welcome": "wˈɛlkʌm", "good": "ɡˈʊd", "morning": "mˈɔːɹnɪŋ",
    "night": "nˈaɪt", "day": "dˈeɪ", "time": "tˈaɪm",
    "music": "mjˈuːzɪk", "voice": "vˈɔɪs", "speech": "spˈiːtʃ",
    "sound": "sˈaʊnd", "water": "wˈɔːɾɚ", "better": "bˈɛɾɚ",
    "little": "lˈɪɾəl", "people": "pˈiːpəl", "about": "ɐbˈaʊt",
    "because": "bɪkˈʌz", "love": "lˈʌv", "over": "ˈoʊvɚ",
    "under": "ˈʌndɚ", "again": "ɐɡˈɛn", "never": "nˈɛvɚ",
    "house": "hˈaʊs", "thank": "θˈæŋk", "thanks": "θˈæŋks",
    "please": "plˈiːz", "yes": "jˈɛs", "no": "nˈoʊ",
    "computer": "kəmpjˈuːɾɚ", "language": "lˈæŋɡwɪdʒ",
    "model": "mˈɑːdəl", "number": "nˈʌmbɚ", "word": "wˈɜːd",
    "sing": "sˈɪŋ", "song": "sˈɔːŋ", "dog": "dˈɑːɡ", "cat": "kˈæt",
    "bird": "bˈɜːd", "fire": "fˈaɪɚ", "light": "lˈaɪt",
    "dark": "dˈɑːɹk", "right": "ɹˈaɪt", "left": "lˈɛft",
    "up": "ˈʌp", "down": "dˈaʊn", "here": "hˈɪɹ", "there": "ðˈɛɹ",
    "where": "wˈɛɹ", "when": "wˈɛn", "how": "hˈaʊ", "who": "hˈuː",
    "why": "wˈaɪ", "all": "ˈɔːl", "some": "sˈʌm", "more": "mˈoːɹ",
    "very": "vˈɛɹi", "out": "ˈaʊt", "new": "nˈuː", "old": "ˈoʊld",
    "now": "nˈaʊ", "then": "ðˈɛn", "make": "mˈeɪk", "like": "lˈaɪk",
    "just": "dʒˈʌst", "know": "nˈoʊ", "take": "tˈeɪk", "come": "kˈʌm",
    "think": "θˈɪŋk", "see": "sˈiː", "way": "wˈeɪ", "look": "lˈʊk",
    "first": "fˈɜːst", "work": "wˈɜːk", "life": "lˈaɪf", "year": "jˈɪɹ",
    "name": "nˈeɪm", "play": "plˈeɪ", "read": "ɹˈiːd", "said": "sˈɛd",
    "friend": "fɹˈɛnd", "today": "tədˈeɪ", "speak": "spˈiːk",
    "listen": "lˈɪsən", "story": "stˈoːɹi", "happy": "hˈæpi",
    "quick": "kwˈɪk", "brown": "bɹˈaʊn", "fox": "fˈɑːks",
    "jumps": "dʒˈʌmps", "lazy": "lˈeɪzi",
}


def _espeak_binary() -> str | None:
    import shutil

    for name in ("espeak-ng", "espeak"):
        p = shutil.which(name)
        if p:
            return p
    return None


_ESPEAK_LIB = None


def _espeak_lib():
    """ctypes handle to libespeak-ng.so when present (initialized once)."""
    global _ESPEAK_LIB
    if _ESPEAK_LIB is not None:
        return _ESPEAK_LIB or None
    import ctypes
    import ctypes.util
    import os

    # probe order: explicit env override, a user-built .so dropped next to
    # the other native/ artifacts (the loader pattern audiohost uses), then
    # the system linker.  Building espeak-ng in-tree is NOT possible in
    # this image (no source tarball, no apt/pip package, zero network
    # egress, and the reference ships only a Windows PE DLL with no
    # espeak-ng-data) — but any environment that has or builds the library
    # gets exact reference parity with no code change.
    candidates = [os.environ.get("AUDIOLAB_ESPEAK_LIB")]
    native_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native")
    candidates += [os.path.join(native_dir, "libespeak-ng.so"),
                   os.path.join(native_dir, "libespeak.so")]
    path = next((c for c in candidates if c and os.path.exists(c)), None)
    if not path:
        path = (ctypes.util.find_library("espeak-ng")
                or ctypes.util.find_library("espeak"))
    if not path:
        _ESPEAK_LIB = False
        return None
    try:
        lib = ctypes.cdll.LoadLibrary(path)
        # espeak_Initialize(AUDIO_OUTPUT_RETRIEVAL=1, 0, NULL, 0)
        if lib.espeak_Initialize(1, 0, None, 0) < 0:
            _ESPEAK_LIB = False
            return None
        lib.espeak_TextToPhonemes.restype = ctypes.c_char_p
        _ESPEAK_LIB = lib
        return lib
    except OSError:
        _ESPEAK_LIB = False
        return None


def espeak_available() -> bool:
    return _espeak_binary() is not None or _espeak_lib() is not None


def phonemize_espeak(text: str, lang: str = "en-us") -> str | None:
    """Exact espeak IPA (stress marks included) via the binary or
    libespeak-ng; None when neither is present."""
    exe = _espeak_binary()
    if exe is not None:
        r = _subprocess.run([exe, "-q", "--ipa", "-v", lang, text],
                            capture_output=True, text=True)
        if r.returncode == 0 and r.stdout.strip():
            s = re.sub(r"\([a-z-]+\)", "", r.stdout)  # language-switch flags
            return " ".join(s.split())
    lib = _espeak_lib()
    if lib is not None:
        import ctypes

        lib.espeak_SetVoiceByName(lang.encode())
        buf = ctypes.create_string_buffer(text.encode("utf-8"))
        ptr = ctypes.cast(ctypes.pointer(buf), ctypes.c_void_p)
        ref = ctypes.pointer(ptr)
        parts = []
        while ptr.value:
            # textmode 1 = UTF-8 input; phonememode 0x02 = IPA glyphs
            out = lib.espeak_TextToPhonemes(ref, 1, 0x02)
            if not out:
                break
            parts.append(out.decode("utf-8", errors="replace").strip())
        if parts:
            return " ".join(" ".join(parts).split())
    return None


def _word_to_ipa(word: str) -> str:
    if word in _IPA_LEXICON:
        return _IPA_LEXICON[word]
    phones = word_to_phonemes(word)
    ipa = [_ARPA_TO_IPA.get(p, "") for p in phones if p != "sil"]
    # naive primary stress: espeak places the mark directly before the
    # stressed vowel; without dictionary stress, mark the first vowel
    for i, g in enumerate(ipa):
        if g and g[0] in _IPA_VOWELS:
            ipa[i] = "ˈ" + g
            break
    return "".join(ipa)


def phonemize_ipa(text: str, lang: str = "en-us") -> str:
    """Text -> espeak-convention IPA string for checkpoint-compatible
    tokenization (models/zonos.tokenize_phonemes_np -> phoneme_embedder
    rows).  Uses the real espeak front-end when available; the lexicon +
    rule fallback otherwise.  Punctuation .,!?;: is preserved (it is part
    of the Zonos symbol table, conditioning.py:28)."""
    real = phonemize_espeak(text, lang)
    if real is not None:
        return real
    out: list[str] = []
    for tok in normalize_text(text).split():
        bare = tok.strip(".,!?")
        if bare:
            out.append(_word_to_ipa(bare))
        if tok[-1:] in ".,!?":
            out[-1] = (out[-1] if bare else "") + tok[-1]
    return " ".join(out)
