"""The port's own copy of ``lightningfastspeech2_tpu/synthesis/g2p.py``:
lexicon, then the neural OOV fallback (``neural=``, a
``synthesis.neural_g2p.NeuralG2P``) where given, then the rule LTS.

Grapheme-to-phoneme conversion.

Same contract as the reference's G2P layer
(reference ``litfass/synthesis/g2p.py``): NFKD-normalize + lowercase,
per-word lexicon lookup with a fallback for OOV words, stress stripping,
ARPABET->IPA, trailing punctuation as ``[FULL STOP]``-style unicode-name
tokens, ``[SILENCE]`` after each unpunctuated word.

The reference's OOV fallback is the g2p_en neural model (unavailable
offline); here it is a deterministic English letter-to-sound ruleset, and
the lexicon path accepts CMUdict-format TSV/space files so users can plug
the full dictionary for production quality.
"""

from __future__ import annotations

import re
import unicodedata
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from lightningfastspeech2_tpu_torch.data.vocab import SILENCE, strip_stress, to_ipa

# the shipped CMUdict-format lexicon (the generate CLI's 'builtin' lexicon)
BUILTIN_LEXICON = str(Path(__file__).resolve().parent.parent / "data"
                      / "lexicon_en_expanded.txt")


class G2P(ABC):
    def __init__(self, lexicon_path: Optional[str] = None, neural=None):
        self.lexicon_path = lexicon_path
        self.lexicon = self.load_lexicon()
        # OOV fallback: a synthesis.neural_g2p.NeuralG2P (the analog of the
        # reference's g2p_en model, g2p.py:4); rule LTS when absent
        self.neural = neural

    @abstractmethod
    def __call__(self, text: str) -> List[str]: ...

    def load_lexicon(self) -> Dict[str, List[str]]:
        lexicon: Dict[str, List[str]] = {}
        if self.lexicon_path is None:
            return lexicon
        with open(self.lexicon_path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith(";"):
                    continue
                parts = line.split("\t") if "\t" in line else line.split(None, 1)
                if len(parts) != 2:
                    continue
                word, phones = parts
                # CMUdict alternates like "WORD(2)"
                word = re.sub(r"\(\d+\)$", "", word)
                lexicon.setdefault(word.lower(), phones.split())
        return lexicon


# deterministic letter-to-sound rules for OOV words (longest-match-first);
# intentionally simple — plug a CMUdict lexicon for production
_LTS_RULES: Sequence = (
    ("tion", ["SH", "AH0", "N"]), ("sion", ["ZH", "AH0", "N"]),
    ("ough", ["OW1"]), ("igh", ["AY1"]), ("tch", ["CH"]),
    ("sch", ["S", "K"]), ("ing", ["IH0", "NG"]),
    ("ai", ["EY1"]), ("ay", ["EY1"]), ("au", ["AO1"]), ("aw", ["AO1"]),
    ("ee", ["IY1"]), ("ea", ["IY1"]), ("ey", ["IY1"]), ("ei", ["EY1"]),
    ("ie", ["IY1"]), ("oa", ["OW1"]), ("oo", ["UW1"]), ("ou", ["AW1"]),
    ("ow", ["OW1"]), ("oy", ["OY1"]), ("oi", ["OY1"]), ("ue", ["UW1"]),
    ("ch", ["CH"]), ("sh", ["SH"]), ("th", ["TH"]), ("ph", ["F"]),
    ("wh", ["W"]), ("ck", ["K"]), ("ng", ["NG"]), ("qu", ["K", "W"]),
    ("kn", ["N"]), ("wr", ["R"]), ("gh", ["G"]),
    ("a", ["AE1"]), ("b", ["B"]), ("c", ["K"]), ("d", ["D"]),
    ("e", ["EH1"]), ("f", ["F"]), ("g", ["G"]), ("h", ["HH"]),
    ("i", ["IH1"]), ("j", ["JH"]), ("k", ["K"]), ("l", ["L"]),
    ("m", ["M"]), ("n", ["N"]), ("o", ["AA1"]), ("p", ["P"]),
    ("q", ["K"]), ("r", ["R"]), ("s", ["S"]), ("t", ["T"]),
    ("u", ["AH1"]), ("v", ["V"]), ("w", ["W"]), ("x", ["K", "S"]),
    ("y", ["Y"]), ("z", ["Z"]),
)


def letter_to_sound(word: str) -> List[str]:
    phones: List[str] = []
    i = 0
    word = re.sub(r"[^a-z]", "", word)
    # silent final e heuristic
    if len(word) > 2 and word.endswith("e") and word[-2] not in "aeiou":
        word = word[:-1]
    while i < len(word):
        for pat, ph in _LTS_RULES:
            if word.startswith(pat, i):
                phones += ph
                i += len(pat)
                break
        else:
            i += 1
    return phones


class EnglishG2P(G2P):
    """English text -> IPA phone tokens (g2p.py:22-65 semantics)."""

    def __call__(self, text: str) -> List[str]:
        text = unicodedata.normalize("NFKD", text).lower()
        phones: List[str] = []
        for word in text.split(" "):
            if not word:
                continue
            punctuation = ""
            if word[-1] in ".,!?;:":
                punctuation, word = word[-1], word[:-1]
            raw = self.lexicon.get(word)
            if raw is None and self.neural is not None:
                raw = self.neural([word])[0]
            if not raw:
                raw = letter_to_sound(word)
            for phone in raw:
                phone = strip_stress(phone)
                phones.append(to_ipa(phone, "arpabet"))
            if punctuation:
                phones.append("[" + unicodedata.name(punctuation) + "]")
            else:
                phones.append(SILENCE)
        return phones
