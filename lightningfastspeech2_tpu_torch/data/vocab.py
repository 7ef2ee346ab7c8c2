"""The port's own copy of ``lightningfastspeech2_tpu/data/vocab.py``.

Phone vocabulary and phoneset conversion.

The reference strips stress digits, converts ARPABET to IPA via the
``phones`` package with a memo cache, spells silence/punctuation tokens as
``[SILENCE]``, ``[FULL STOP]`` etc., and reserves ``[PAD]=0``
(reference ``litfass/dataset/datasets.py:106-109,553-560,704-721``,
``litfass/synthesis/g2p.py:43-51``). The ``phones`` package is unavailable
here, so the ARPABET->IPA mapping is the standard published table.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

PAD = "[PAD]"
SILENCE = "[SILENCE]"

# Special tokens the G2P/punctuation layer emits (g2p.py:21-26 semantics)
PUNCTUATION_TOKENS = {
    ".": "[FULL STOP]",
    ",": "[COMMA]",
    "!": "[EXCLAMATION MARK]",
    "?": "[QUESTION MARK]",
    ";": "[SEMICOLON]",
    ":": "[COLON]",
}

# Standard ARPABET -> IPA correspondence (public phoneset table)
ARPABET_TO_IPA: Dict[str, str] = {
    "AA": "ɑ", "AE": "æ", "AH": "ʌ", "AO": "ɔ", "AW": "aʊ", "AY": "aɪ",
    "B": "b", "CH": "tʃ", "D": "d", "DH": "ð", "EH": "ɛ", "ER": "ɝ",
    "EY": "eɪ", "F": "f", "G": "ɡ", "HH": "h", "IH": "ɪ", "IY": "i",
    "JH": "dʒ", "K": "k", "L": "l", "M": "m", "N": "n", "NG": "ŋ",
    "OW": "oʊ", "OY": "ɔɪ", "P": "p", "R": "ɹ", "S": "s", "SH": "ʃ",
    "T": "t", "TH": "θ", "UH": "ʊ", "UW": "u", "V": "v", "W": "w",
    "Y": "j", "Z": "z", "ZH": "ʒ",
}


def strip_stress(phone: str) -> str:
    """Remove stress markers (digits 0-2 and IPA secondary stress)
    (datasets.py:708-712 strips '0'/'1'; '2' is included for completeness
    with g2p.py:47)."""
    phone = phone.replace("ˌ", "")
    stripped = phone.replace("0", "").replace("1", "").replace("2", "")
    return stripped if stripped else phone


def to_ipa(phone: str, source_phoneset: str = "arpabet") -> str:
    """Convert a (stress-stripped) phone to IPA; special [..] tokens pass
    through, unknown phones pass through unchanged."""
    if "[" in phone:
        return phone
    phone = strip_stress(phone)
    if source_phoneset == "arpabet":
        return ARPABET_TO_IPA.get(phone.upper(), phone)
    return phone


def normalize_phone(phone: str, source_phoneset: str = "arpabet") -> str:
    """Full reference pipeline for one raw alignment label: silence labels
    -> [SILENCE], else stress-strip + IPA."""
    if phone in ("sil", "sp", "spn", ""):
        return SILENCE
    return to_ipa(phone, source_phoneset)


class Vocab:
    """phone2id with [PAD]=0 (datasets.py:553-560: sorted unique phones,
    pad first)."""

    def __init__(self, phones: Iterable[str]):
        uniq = sorted(set(phones) - {PAD})
        self.phone2id: Dict[str, int] = {PAD: 0}
        for i, p in enumerate(uniq, start=1):
            self.phone2id[p] = i
        self.id2phone = {i: p for p, i in self.phone2id.items()}

    def __len__(self) -> int:
        return len(self.phone2id)

    def encode(self, phones: Sequence[str]) -> List[int]:
        return [self.phone2id[p] for p in phones]

    def decode(self, ids: Sequence[int]) -> List[str]:
        return [self.id2phone[int(i)] for i in ids]

    def to_dict(self) -> Dict[str, int]:
        return dict(self.phone2id)

    @classmethod
    def from_dict(cls, d: Dict[str, int]) -> "Vocab":
        v = cls([])
        v.phone2id = dict(d)
        v.id2phone = {i: p for p, i in d.items()}
        return v
