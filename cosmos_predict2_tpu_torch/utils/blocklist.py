"""Text blocklist guardrail: censor + lemma + exact/partial matching.

The port's copy of cosmos_predict2_tpu/utils/blocklist.py, a behavioral
port of the reference blocklist safety model
(imaginaire/auxiliary/guardrail/blocklist/blocklist.py, utils.py) without
its dependencies: ``better_profanity`` is replaced by a leet-variant word
censor with the same matching semantics, and nltk's WordNetLemmatizer by a
morphy-style rule lemmatizer. The pipeline is the reference's, stage for
stage (blocklist.py:204-233 is_safe):

  1. to_ascii normalization,
  2. censor the raw prompt against the (fuzzy, leet-aware) blocklist with
     whitelist uncensoring,
  3. censor the lemmatized prompt the same way,
  4. exact whole-word + SequenceMatcher partial match against the
     exact-match list (blocklist.py:96-201).

Word lists load from a checkpoint directory with the reference's layout
(``custom/`` ``whitelist/`` ``exact_match/``, one keyword per line, any
number of files per directory, read_keyword_list_from_dir), so the released
Cosmos-Guardrail1 blocklist drops in unchanged; without one, a built-in
starter list keeps the check real rather than a no-op. Pure Python.
"""

from __future__ import annotations

import logging
import os
import re
import string
from difflib import SequenceMatcher
from itertools import islice, product

log = logging.getLogger("cosmos_predict2_tpu_torch")

CENSOR_CHAR = "*"

# Starter blocklist used when no checkpoint dir is given. Deployments load
# the released Cosmos-Guardrail1 lists (hundreds of terms) instead; this
# built-in set covers unambiguous violence/CSAM/sexual-content terms so the
# default-constructed guardrail blocks the obvious cases.
DEFAULT_BLOCKLIST = (
    "gore", "beheading", "behead", "decapitate", "decapitation", "dismember",
    "dismemberment", "mutilate", "mutilation", "disembowel", "eviscerate",
    "torture", "snuff", "necrophilia", "child abuse", "child porn",
    "child pornography", "csam", "cp material", "loli", "lolicon", "shota",
    "shotacon", "rape", "raping", "rapist", "molest", "molestation",
    "bestiality", "zoophilia", "incest", "nude child", "naked child",
    "sexualized minor", "underage sex", "genocide footage", "execution video",
    "mass shooting", "school shooting", "terrorist attack footage",
    "suicide method", "self harm", "self-harm", "hentai", "porn",
    "pornography", "explicit sex", "hardcore sex", "gangbang", "blowjob",
    "handjob", "cumshot", "creampie", "deepthroat", "bukkake", "fisting",
    "bdsm torture", "nonconsensual", "non-consensual",
)

DEFAULT_EXACT_MATCH = (
    "nazi", "hitler", "isis", "kkk", "swastika", "al qaeda", "third reich",
)


def to_ascii(prompt: str) -> str:
    """Strip non-ASCII (reference utils.py to_ascii)."""
    return re.sub(r"[^\x00-\x7F]+", " ", prompt)


def read_keyword_list_from_dir(folder_path: str) -> list[str]:
    """All non-empty lines from every regular file in a directory
    (reference utils.py read_keyword_list_from_dir)."""
    out: list[str] = []
    if not os.path.isdir(folder_path):
        return out
    for name in sorted(os.listdir(folder_path)):
        path = os.path.join(folder_path, name)
        if not os.path.isfile(path):
            continue
        try:
            with open(path, encoding="utf-8", errors="replace") as f:
                out.extend(line.strip() for line in f if line.strip())
        except OSError as e:
            log.error(f"error reading blocklist file {path}: {e}")
    return out


# ------------------------------ lemmatizer ------------------------------

# WordNet morphy detachment rules (noun + verb + adjective), applied
# longest-suffix-first; irregulars from morphy's exception lists that
# plausibly appear in prompts.
_IRREGULAR = {
    "children": "child", "men": "man", "women": "woman", "people": "person",
    "teeth": "tooth", "feet": "foot", "geese": "goose", "mice": "mouse",
    "knives": "knife", "wives": "wife", "lives": "life", "wolves": "wolf",
    "corpses": "corpse",
}

_SUFFIX_RULES = (
    # (suffix, replacement, min stem length) — specials first, then the
    # plain plural (so "tortures" -> "torture", not "tortur"), then verb
    # endings
    ("ches", "ch", 2), ("shes", "sh", 2), ("sses", "ss", 2), ("xes", "x", 2),
    ("zes", "z", 2), ("ves", "f", 2), ("ies", "y", 2),
    ("s", "", 3),
    ("ing", "", 3), ("ing", "e", 3), ("ed", "", 3), ("ed", "e", 3),
)


def lemmatize(word: str) -> str:
    """Morphy-style lemma of a lowercase token: irregular table, then the
    longest applicable detachment rule. Counterpart of the reference's
    ``nltk.WordNetLemmatizer().lemmatize(token)`` (blocklist.py:218)."""
    w = word.lower()
    if w in _IRREGULAR:
        return _IRREGULAR[w]
    for suffix, repl, min_stem in _SUFFIX_RULES:
        if w.endswith(suffix) and len(w) - len(suffix) >= min_stem:
            stem = w[: -len(suffix)] + repl
            # avoid degenerate stems like "ss" -> "s"
            if len(stem) >= 2:
                return stem
    return w


# ----------------------------- leet censor -----------------------------

# better_profanity's character variant map (the fuzzy matching the
# reference relies on for the censor stage).
_CHAR_VARIANTS = {
    "a": ("a", "@", "4"),
    "e": ("e", "3"),
    "i": ("i", "1", "!", "l"),
    "l": ("l", "1"),
    "o": ("o", "0"),
    "s": ("s", "$", "5"),
    "t": ("t", "7"),
    "u": ("u", "v"),
    "b": ("b", "8"),
    "g": ("g", "9"),
}
_MAX_VARIANTS_PER_WORD = 256


def _word_variants(word: str) -> list[str]:
    """Leet-speak spellings of one (possibly multi-token) phrase, capped."""
    pools = [_CHAR_VARIANTS.get(ch, (ch,)) for ch in word]
    return ["".join(c) for c in islice(product(*pools), _MAX_VARIANTS_PER_WORD)]


class LeetCensor:
    """Word-boundary censor over blocklist words and their leet variants
    (the ``better_profanity.censor`` stage of the reference)."""

    def __init__(self, words: list[str] | tuple[str, ...], whitelist: list[str] | tuple[str, ...] = ()):
        white = {w.strip().lower() for w in whitelist}
        variants: set[str] = set()
        for word in words:
            w = re.sub(r"\s+", " ", word).strip().lower()
            if not w or w in white:
                continue
            variants.update(v for v in _word_variants(w) if v not in white)
        self._words = variants
        if variants:
            # one alternation, longest first so phrases beat their prefixes
            pattern = "|".join(re.escape(v).replace(r"\ ", r"\s+") for v in sorted(variants, key=len, reverse=True))
            # boundary class: word chars plus the leet symbols that can sit
            # INSIDE a variant ('@', '$') — but not '!', which usually ends a
            # sentence right after a word
            self._re = re.compile(rf"(?<![\w@$])(?:{pattern})(?![\w@$])", re.IGNORECASE)
        else:
            self._re = None

    def censor(self, text: str, censor_char: str = CENSOR_CHAR) -> str:
        if self._re is None:
            return text
        return self._re.sub(lambda m: censor_char * 4, text)


# ------------------------------- blocklist -------------------------------


class Blocklist:
    """The reference's Blocklist safety model (blocklist.py:36-233).

    ``checkpoint_dir`` points at the released blocklist layout
    (``custom/``, ``whitelist/``, ``exact_match/`` subdirectories); when
    absent the built-in starter lists are used.
    """

    def __init__(
        self,
        checkpoint_dir: str | None = None,
        partial_match_min_chars: int = 6,
        partial_match_letter_count: float = 0.4,
    ):
        self.partial_match_min_chars = partial_match_min_chars
        self.partial_match_letter_count = partial_match_letter_count
        if checkpoint_dir:
            self.blocklist_words = read_keyword_list_from_dir(os.path.join(checkpoint_dir, "custom"))
            self.whitelist_words = read_keyword_list_from_dir(os.path.join(checkpoint_dir, "whitelist"))
            self.exact_match_words = read_keyword_list_from_dir(os.path.join(checkpoint_dir, "exact_match"))
        else:
            self.blocklist_words = list(DEFAULT_BLOCKLIST)
            self.whitelist_words = []
            self.exact_match_words = list(DEFAULT_EXACT_MATCH)
        self._censor = LeetCensor(self.blocklist_words, self.whitelist_words)
        log.debug(
            f"blocklist: {len(self.blocklist_words)} words, "
            f"{len(self.whitelist_words)} whitelisted, "
            f"{len(self.exact_match_words)} exact-match"
        )

    # -------------------------- censor stage --------------------------

    def uncensor_whitelist(self, input_prompt: str, censored_prompt: str) -> str:
        """Restore whitelisted tokens the fuzzy censor caught
        (blocklist.py:80-90)."""
        input_words = input_prompt.split()
        censored_words = censored_prompt.split()
        white = set(w.lower() for w in self.whitelist_words)
        for i, token in enumerate(input_words):
            if i < len(censored_words) and token.strip(string.punctuation).lower() in white:
                censored_words[i] = token
        return " ".join(censored_words)

    def censor_prompt(self, input_prompt: str) -> tuple[bool, str]:
        censored = self._censor.censor(input_prompt, CENSOR_CHAR)
        censored = self.uncensor_whitelist(input_prompt, censored)
        if CENSOR_CHAR in censored:
            return True, f"Prompt blocked by censorship: Censored Prompt: {censored}"
        return False, ""

    # ------------------------ exact/partial stage ------------------------

    @staticmethod
    def check_partial_match(
        normalized_prompt: str, normalized_word: str, partial_match_letter_count: float
    ) -> tuple[bool, str]:
        """Sliding SequenceMatcher over same-word-count windows, with the
        quick-ratio upper-bound early exits (blocklist.py:96-141)."""
        prompt_words = normalized_prompt.split()
        word_length = len(normalized_word.split())
        max_ratio = (len(normalized_word) - float(partial_match_letter_count)) / float(len(normalized_word))

        matcher = SequenceMatcher(None)
        matcher.set_seq2(normalized_word)
        for i in range(len(prompt_words) - word_length + 1):
            window = " ".join(prompt_words[i : i + word_length])
            matcher.set_seq1(window)
            if matcher.real_quick_ratio() < max_ratio or matcher.quick_ratio() < max_ratio:
                continue
            if matcher.ratio() >= max_ratio:
                return True, (
                    f"Prompt blocked by partial match blocklist: Prompt: {normalized_prompt}, "
                    f"Partial Match Word: {normalized_word}"
                )
        return False, ""

    @staticmethod
    def check_against_whole_word_blocklist(
        prompt: str,
        blocklist: list[str],
        partial_match_min_chars: int = 6,
        partial_match_letter_count: float = 0.4,
    ) -> tuple[bool, str]:
        """Whole-word then partial matching against the exact-match list
        (blocklist.py:144-201: exact loop first for early exit, then the
        partial loop over the cached normalized words)."""
        normalized_prompt = re.sub(r"\s+", " ", prompt).strip().lower()
        normalized: list[str] = []
        seen: set[str] = set()
        for word in blocklist:
            w = re.sub(r"\s+", " ", word).strip().lower()
            if w and w not in seen:
                seen.add(w)
                normalized.append(w)
                if re.search(r"\b" + re.escape(w) + r"\b", normalized_prompt):
                    return True, f"Prompt blocked by exact match blocklist: Prompt: {prompt}, Exact Match Word: {word}"
        for w in normalized:
            if len(w) >= partial_match_min_chars:
                match, message = Blocklist.check_partial_match(normalized_prompt, w, partial_match_letter_count)
                if match:
                    return True, message
        return False, ""

    # ------------------------------ is_safe ------------------------------

    def is_safe(self, input_prompt: str = "") -> tuple[bool, str]:
        if not input_prompt:
            return False, "Input is empty"
        input_prompt = to_ascii(input_prompt)

        blocked, message = self.censor_prompt(input_prompt)
        if blocked:
            return False, message

        tokens = re.findall(r"\w+|[^\w\s]", input_prompt)
        lemmatized = " ".join(lemmatize(t) if t.isalpha() else t for t in tokens)
        blocked, message = self.censor_prompt(lemmatized)
        if blocked:
            return False, message

        blocked, message = self.check_against_whole_word_blocklist(
            input_prompt,
            self.exact_match_words,
            self.partial_match_min_chars,
            self.partial_match_letter_count,
        )
        if blocked:
            return False, message
        return True, "Input is safe"
