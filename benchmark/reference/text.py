"""TPC-H's pseudo text (clause 4.2.2.14) and its text strings (4.2.2.10).

The text pool is sentences of the grammar below, words drawn by their
weights, generated once a run from the seed; a text string of length
[lo, hi] is a substring of the pool at a random offset in
[0, size - hi] and of a random length in [lo, hi].  The word lists and
their weights are dbgen's ``dists.dss`` (``nouns``, ``verbs``,
``adjectives``, ``adverbs``, ``prepositions``, ``auxillaries``,
``terminators``; ``grammar``, ``np``, ``vp``).

Vectorised: the sentences are expanded level by level (sentence →
phrases → word classes → words) as arrays of symbols, and the words'
bytes are gathered in one pass.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

NOUNS = (("packages", 40), ("requests", 40), ("accounts", 40), ("deposits", 40),
         ("foxes", 20), ("ideas", 20), ("theodolites", 20), ("pinto beans", 20),
         ("instructions", 20), ("dependencies", 10), ("excuses", 10), ("platelets", 10),
         ("asymptotes", 10), ("courts", 5), ("dolphins", 5), ("multipliers", 1),
         ("sauternes", 1), ("warthogs", 1), ("frets", 1), ("dinos", 1), ("attainments", 1),
         ("somas", 1), ("Tiresias", 1), ("patterns", 1), ("forges", 1), ("braids", 1),
         ("frays", 1), ("warhorses", 1), ("dugouts", 1), ("notornis", 1), ("epitaphs", 1),
         ("pearls", 1), ("tithes", 1), ("waters", 1), ("orbits", 1), ("gifts", 1),
         ("sheaves", 1), ("depths", 1), ("sentiments", 1), ("decoys", 1), ("realms", 1),
         ("pains", 1), ("grouches", 1), ("escapades", 1), ("hockey players", 1))
VERBS = (("sleep", 20), ("wake", 20), ("are", 20), ("cajole", 20), ("haggle", 20),
         ("nag", 10), ("use", 10), ("boost", 10), ("affix", 5), ("detect", 5),
         ("integrate", 5), ("maintain", 1), ("nod", 1), ("was", 1), ("lose", 1),
         ("sublate", 1), ("solve", 1), ("thrash", 1), ("promise", 1), ("engage", 1),
         ("hinder", 1), ("print", 1), ("x-ray", 1), ("breach", 1), ("eat", 1), ("grow", 1),
         ("impress", 1), ("mold", 1), ("poach", 1), ("serve", 1), ("run", 1), ("dazzle", 1),
         ("snooze", 1), ("doze", 1), ("unwind", 1), ("kindle", 1), ("play", 1), ("hang", 1),
         ("believe", 1), ("doubt", 1))
ADJECTIVES = (("special", 20), ("pending", 20), ("unusual", 20), ("express", 20),
              ("furious", 1), ("sly", 1), ("careful", 1), ("blithe", 1), ("quick", 1),
              ("fluffy", 1), ("slow", 1), ("quiet", 1), ("ruthless", 1), ("thin", 1),
              ("close", 1), ("dogged", 1), ("daring", 1), ("brave", 1), ("stealthy", 1),
              ("permanent", 1), ("enticing", 1), ("idle", 1), ("busy", 1), ("regular", 50),
              ("final", 40), ("ironic", 40), ("even", 30), ("bold", 20), ("silent", 10))
ADVERBS = (("sometimes", 1), ("always", 1), ("never", 1), ("furiously", 50), ("slyly", 50),
           ("carefully", 50), ("blithely", 40), ("quickly", 30), ("fluffily", 20),
           ("slowly", 1), ("quietly", 1), ("ruthlessly", 1), ("thinly", 1), ("closely", 1),
           ("doggedly", 1), ("daringly", 1), ("bravely", 1), ("stealthily", 1),
           ("permanently", 1), ("enticingly", 1), ("idly", 1), ("busily", 1),
           ("regularly", 1), ("finally", 1), ("ironically", 1), ("evenly", 1), ("boldly", 1),
           ("silently", 1))
PREPOSITIONS = (("about", 50), ("above", 50), ("according to", 50), ("across", 50),
                ("after", 50), ("against", 40), ("along", 40), ("alongside of", 30),
                ("among", 30), ("around", 20), ("at", 10), ("atop", 1), ("before", 1),
                ("behind", 1), ("beneath", 1), ("beside", 1), ("besides", 1), ("between", 1),
                ("beyond", 1), ("by", 1), ("despite", 1), ("during", 1), ("except", 1),
                ("for", 1), ("from", 1), ("in place of", 1), ("inside", 1), ("instead of", 1),
                ("into", 1), ("near", 1), ("of", 1), ("on", 1), ("outside", 1), ("over", 1),
                ("past", 1), ("since", 1), ("through", 1), ("throughout", 1), ("to", 1),
                ("toward", 1), ("under", 1), ("until", 1), ("up", 1), ("upon", 1),
                ("without", 1), ("with", 1), ("within", 1))
AUXILIARIES = (("do", 1), ("may", 1), ("might", 1), ("shall", 1), ("will", 1), ("would", 1),
               ("can", 1), ("could", 1), ("should", 1), ("ought to", 1), ("must", 1),
               ("will have to", 1), ("shall have to", 1), ("could have to", 1),
               ("should have to", 1), ("must have to", 1), ("need to", 1), ("try to", 1))
TERMINATORS = ((".", 50), (";", 1), (":", 1), ("?", 1), ("!", 1), ("--", 1))

# symbols: word classes (terminal), then phrases (expanded)
N, J, JC, D, V, X, P, THE, T, S, NP, VP, PP = range(13)
CLASSES = {N: NOUNS, J: ADJECTIVES, JC: ADJECTIVES, D: ADVERBS, V: VERBS, X: AUXILIARIES,
           P: PREPOSITIONS, T: TERMINATORS}
# grammar: sentence (N V T|3, N V P T|3, N V N T|3, N P V N T|1, N P V P T|1)
SENTENCE = ((3, (NP, VP, T)), (3, (NP, VP, PP, T)), (3, (NP, VP, NP, T)),
            (1, (NP, PP, VP, NP, T)), (1, (NP, PP, VP, PP, T)))
# np (N|10, J N|20, J, J N|10, D J N|50); vp (V|30, X V|1, V D|40, X V D|1)
NOUN_PHRASE = ((10, (N,)), (20, (J, N)), (10, (JC, J, N)), (50, (D, J, N)))
VERB_PHRASE = ((30, (V,)), (1, (X, V)), (40, (V, D)), (1, (X, V, D)))
PREP_PHRASE = ((1, (P, THE, NP)),)


def _pick(rng, weights: Sequence[int], n: int) -> np.ndarray:
    cum = np.cumsum(np.asarray(weights, dtype=np.int64))
    return np.searchsorted(cum, rng.integers(0, int(cum[-1]), n), side="right")


def _ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The concatenated index ranges [starts[i], starts[i] + lens[i])."""
    lens = np.asarray(lens, dtype=np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    first = np.repeat(np.asarray(starts, dtype=np.int64) - np.cumsum(lens) + lens, lens)
    return first + np.arange(total, dtype=np.int64)


def _expand(rng, syms: np.ndarray, rules: Dict[int, Tuple]) -> np.ndarray:
    """Each symbol with rules replaced by one of its productions, drawn by
    weight; every other symbol kept."""
    seqs: List[Tuple[int, ...]] = [(s,) for s in range(13)]
    choice = syms.astype(np.int64)
    for sym, prods in rules.items():
        at = np.flatnonzero(syms == sym)
        base = len(seqs)
        seqs.extend(p for _w, p in prods)
        choice[at] = base + _pick(rng, [w for w, _p in prods], len(at))
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    flat = np.array([x for s in seqs for x in s], dtype=np.int8)
    return flat[_ranges(offs[choice], lens[choice])]


def _vocabulary():
    """Every word's bytes as it is printed, and each class's first entry:
    a word with a space before it, an adjective of ``JC`` with a comma
    after it, a terminator as it is."""
    words, first = [], {}
    for c in (N, J, JC, D, V, X, P, T):
        first[c] = len(words)
        for w, _n in CLASSES[c]:
            words.append(w if c == T else " " + w + ("," if c == JC else ""))
    first[THE] = len(words)
    words.append(" the")
    return words, first


def text_pool(seed, size: int, chunk: int = 1 << 25) -> np.ndarray:
    """``size`` bytes of TPC-H's pseudo text, drawn from ``seed`` (a
    sequence of whole numbers for ``np.random.default_rng``), made in
    pieces of about ``chunk`` bytes."""
    rng = np.random.default_rng(seed)
    words, first = _vocabulary()
    wlen = np.array([len(w) for w in words], dtype=np.int64)
    woff = np.concatenate([[0], np.cumsum(wlen)[:-1]])
    wbytes = np.frombuffer("".join(words).encode(), np.uint8)
    out = np.empty(size, dtype=np.uint8)
    have = 0
    while have < size:
        n = min(size - have, chunk) // 48 + 1024  # some 60 bytes a sentence
        syms = _expand(rng, np.full(n, S, np.int8), {S: SENTENCE})
        syms = _expand(rng, syms, {PP: PREP_PHRASE})
        syms = _expand(rng, syms, {NP: NOUN_PHRASE, VP: VERB_PHRASE})
        ids = np.empty(len(syms), dtype=np.int64)
        for c in (N, J, JC, D, V, X, P, T):
            at = np.flatnonzero(syms == c)
            ids[at] = first[c] + _pick(rng, [w for _s, w in CLASSES[c]], len(at))
        ids[syms == THE] = first[THE]
        part = wbytes[_ranges(woff[ids], wlen[ids])][: size - have]
        out[have : have + len(part)] = part
        have += len(part)
    return out


def text_strings(rng, pool: np.ndarray, n: int, lo: int, hi: int):
    """``n`` text strings of [lo, hi] bytes from ``pool``: (int64 offsets
    of n + 1, uint8 bytes)."""
    lens = rng.integers(lo, hi + 1, n)
    starts = rng.integers(0, len(pool) - hi + 1, n)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    return offsets, pool[_ranges(starts, lens)]
