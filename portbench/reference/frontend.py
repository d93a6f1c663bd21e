"""Text front end of the reference: the 126-symbol set (pinyin initials and
finals, CMU phonemes, pauses, punctuation), tone and language ids, as the
published model's data pipeline derives them (text/symbols_lmdh.py,
data_utils.get_text_tone): prosody tags #0 #1 #3 #4 and eos stripped,
Mandarin tone digits carried backwards, English stress 7-9 (6 unstressed),
pauses and punctuation 0."""
from __future__ import annotations

import re
from typing import List, Tuple

PAUSE = ["~", "sos", "eos", "unk", "<blank>", "sp", "sil", "#0", "#1", "#2", "#3", "#4"]

INITIALS = [
    "b", "c", "ch", "d", "f", "g", "h", "j", "k", "l", "m", "n", "p", "q", "r",
    "s", "sh", "t", "w", "x", "y", "z", "zh",
]

FINALS = [
    "a", "ai", "an", "ang", "ao", "e", "ei", "en", "eng", "er", "i", "ia",
    "ian", "iang", "iao", "ie", "ii", "iii", "in", "ing", "iong", "iou", "o",
    "ong", "ou", "u", "ua", "uai", "uan", "uang", "uei", "uen", "ueng", "uo",
    "v", "van", "ve", "vn", "xr",
]

CMU = [
    "AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY", "IH", "IY", "OW",
    "OY", "UH", "UW", "P", "B", "CH", "D", "DH", "F", "G", "HH", "JH", "K",
    "L", "M", "N", "NG", "R", "S", "SH", "T", "TH", "V", "W", "Y", "Z", "ZH",
]

PUNCT = ["?", "!", ",", ".", ";", ":", "？", "！", "，", "。", "；", "：", "、"]

SYMBOLS = PAUSE + INITIALS + FINALS + CMU + PUNCT  # 126 entries
TONE_SYMBOLS = ["~", "0", "1", "2", "3", "4", "5", "6", "7", "8", "9"]
LANGUAGE_SYMBOLS = ["~", "1", "2", "3"]

SYMBOL_TO_ID = {s: i for i, s in enumerate(SYMBOLS)}
ID_TO_SYMBOL = {i: s for i, s in enumerate(SYMBOLS)}
TONE_TO_ID = {s: i for i, s in enumerate(TONE_SYMBOLS)}

ENGLISH_START = SYMBOL_TO_ID["AA"]  # 74
PUNCT_START = SYMBOL_TO_ID["?"]  # 113

N_VOCAB = len(SYMBOLS)
N_TONE = len(TONE_SYMBOLS)
N_LANGUAGE = len(LANGUAGE_SYMBOLS)


def _is_english_phoneme(s: str) -> bool:
    return bool(re.search(r"^[A-Z]", s))


def _is_number(s: str) -> bool:
    return bool(re.search(r"^\d", s))


def get_tone(text: str) -> List[str]:
    """Derive per-phoneme tone labels (Mandarin digits 0-5 carried backwards,
    English stress -> 7-9, no-stress 6, pause/punct 0)."""
    split_text = [t.strip() for t in text.split() if t.strip() != ""]
    tone_list: List[str] = []
    pre_tone = "0"
    for item in reversed(split_text):
        if item in PUNCT or item == "<blank>" or item == "#2":
            tone = "0"
        elif _is_english_phoneme(item):
            tone = str(int(item[-1]) + 7) if _is_number(item[-1]) else "6"
        else:
            if _is_number(item[-1]):
                tone = item[-1]
                pre_tone = tone
            else:
                tone = pre_tone
        tone_list.append(tone)
    tone_list = tone_list[::-1]
    tone_list[0] = "0"
    return tone_list


def text_to_sequence(cleaned_text: str) -> List[int]:
    return [SYMBOL_TO_ID[s] for s in cleaned_text.split()]


def tones_to_sequence(tones: List[str]) -> List[int]:
    return [TONE_TO_ID[t] for t in tones]


def language_ids(phoneme_ids: List[int]) -> List[int]:
    """0 pause | 1 Chinese | 2 English | 0 punct (data_utils.py:399-408)."""
    out = []
    for pid in phoneme_ids:
        if pid == 0:
            out.append(0)
        elif pid < ENGLISH_START:
            out.append(1)
        elif pid < PUNCT_START:
            out.append(2)
        else:
            out.append(0)
    return out


def process_text(text: str) -> Tuple[List[int], List[int], List[int]]:
    """Full frontend: strip prosody tags #0/#1/#3/#4 and eos, derive tones,
    strip English stress digits, map to ids (data_utils.get_text_tone)."""
    text = re.sub(r"#0|#1|#3|#4", "", text)
    text = re.sub(r"eos", "", text)
    text = re.sub(r"\s+", " ", text).strip()
    tones = tones_to_sequence(get_tone(text))
    text = re.sub(r"([a-zA-Z])\d", r"\1", text)
    ids = text_to_sequence(text)
    langs = language_ids(ids)
    return ids, tones, langs
