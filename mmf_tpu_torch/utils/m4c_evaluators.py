"""Answer-string evaluators for the M4C task family.

Port of ``mmf_tpu/utils/m4c_evaluators.py`` (reference
mmf/utils/m4c_evaluators.py): ``EvalAIAnswerProcessor`` (the VQA/EvalAI
answer normalisation: contractions, number words, articles,
punctuation; visualqa.org/evaluation.html, whose tables must match
exactly for accuracies to be comparable), ``TextVQAAccuracyEvaluator``
(soft accuracy over ten human answers), ``STVQAAccuracyEvaluator``
(exact match against any ground truth, ST-VQA and OCR-VQA),
``STVQAANLSEvaluator`` (average normalized Levenshtein similarity, through
the C kernels of ``utils/native/editdist``) and ``TextCapsBleu4Evaluator``
(corpus BLEU-4 over lowercased word and punctuation tokens).

``corpus_bleu`` is the port's own copy of
``nltk.translate.bleu_score.corpus_bleu`` with its default arguments,
which JAX's evaluator calls: uniform 4-gram weights and no smoothing,
n-gram counts clipped by their largest count in any reference, the
brevity penalty from each hypothesis's closest reference length over the
corpus, 0 when no unigram matches, and an order with no match counted at
``sys.float_info.min`` (a score of about 1e-77 times the rest) with
nltk's warning.
"""

from __future__ import annotations

import math
import re
import sys
import warnings
from collections import Counter
from typing import Dict, List, Sequence


_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldve": "could've", "couldnt": "couldn't",
    "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
    "hadnt": "hadn't", "hadnt've": "hadn't've", "hadn'tve": "hadn't've",
    "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
    "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've",
    "it'dve": "it'd've", "itll": "it'll", "let's": "let's",
    "maam": "ma'am", "mightnt": "mightn't", "mightnt've": "mightn't've",
    "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's",
    "somethingd": "something'd", "somethingd've": "something'd've",
    "something'dve": "something'd've", "somethingll": "something'll",
    "thats": "that's", "thered": "there'd", "thered've": "there'd've",
    "there'dve": "there'd've", "therere": "there're", "theres": "there's",
    "theyd": "they'd", "theyd've": "they'd've", "they'dve": "they'd've",
    "theyll": "they'll", "theyre": "they're", "theyve": "they've",
    "twas": "'twas", "wasnt": "wasn't", "wed've": "we'd've",
    "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's",
    "whatve": "what've", "whens": "when's", "whered": "where'd",
    "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "whod've": "who'd've", "who'dve": "who'd've", "wholl": "who'll",
    "whos": "who's", "whove": "who've", "whyll": "why'll",
    "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}

_NUMBER_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}

_ARTICLES = ("a", "an", "the")
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(?<=\d)(\,)+(?=\d)")
_PUNCTUATIONS = [
    ";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_",
    "-", ">", "<", "@", "`", ",", "?", "!",
]


class EvalAIAnswerProcessor:
    """Normalizes an answer string per the EvalAI/VQA evaluation spec."""

    CONTRACTIONS = _CONTRACTIONS
    NUMBER_MAP = _NUMBER_MAP
    ARTICLES = list(_ARTICLES)
    PERIOD_STRIP = _PERIOD_STRIP
    COMMA_STRIP = _COMMA_STRIP
    PUNCTUATIONS = _PUNCTUATIONS

    def __init__(self, *args, **kwargs):
        pass

    def word_tokenize(self, word: str) -> str:
        word = word.lower()
        word = word.replace(",", "").replace("?", "").replace("'s", " 's")
        return word.strip()

    def process_punctuation(self, in_text: str) -> str:
        out_text = in_text
        for p in self.PUNCTUATIONS:
            if (p + " " in in_text or " " + p in in_text) or (
                re.search(self.COMMA_STRIP, in_text) is not None
            ):
                out_text = out_text.replace(p, "")
            else:
                out_text = out_text.replace(p, " ")
        out_text = self.PERIOD_STRIP.sub("", out_text, re.UNICODE)
        return out_text

    def process_digit_article(self, in_text: str) -> str:
        out_text = []
        for word in in_text.lower().split():
            word = self.NUMBER_MAP.get(word, word)
            if word not in self.ARTICLES:
                out_text.append(word)
        for i, word in enumerate(out_text):
            if word in self.CONTRACTIONS:
                out_text[i] = self.CONTRACTIONS[word]
        return " ".join(out_text)

    def __call__(self, item: str) -> str:
        item = self.word_tokenize(item)
        item = item.replace("\n", " ").replace("\t", " ").strip()
        item = self.process_punctuation(item)
        item = self.process_digit_article(item)
        return item


class TextVQAAccuracyEvaluator:
    """Soft-voted accuracy over 10 human answers."""

    def __init__(self):
        self.answer_processor = EvalAIAnswerProcessor()

    def _compute_answer_scores(self,
                               raw_answers: List[str]) -> Dict[str, float]:
        answers = [self.answer_processor(a) for a in raw_answers]
        assert len(answers) == 10
        gt_answers = list(enumerate(answers))
        unique_answer_scores = {}
        for unique_answer in set(answers):
            accs = []
            for gt_answer in gt_answers:
                other = [item for item in gt_answers if item != gt_answer]
                matching = [item for item in other if item[1] == unique_answer]
                accs.append(min(1, float(len(matching)) / 3))
            unique_answer_scores[unique_answer] = sum(accs) / len(accs)
        return unique_answer_scores

    def eval_pred_list(self, pred_list) -> float:
        pred_scores = []
        for entry in pred_list:
            pred_answer = self.answer_processor(entry["pred_answer"])
            scores = self._compute_answer_scores(entry["gt_answers"])
            pred_scores.append(scores.get(pred_answer, 0.0))
        return sum(pred_scores) / max(len(pred_scores), 1)


def levenshtein(s1: str, s2: str) -> int:
    """Edit distance in characters (the C kernel of
    ``utils/native/editdist``; non-ASCII text through its character DP)."""
    from mmf_tpu_torch.utils.native.editdist import edit_distance

    return edit_distance(s1, s2)


class STVQAAccuracyEvaluator:
    """1 where the normalised prediction equals a normalised ground
    truth, else 0, averaged."""

    def __init__(self):
        self.answer_processor = EvalAIAnswerProcessor()

    def eval_pred_list(self, pred_list) -> float:
        pred_scores = []
        for entry in pred_list:
            pred_answer = self.answer_processor(entry["pred_answer"])
            gts = [self.answer_processor(a) for a in entry["gt_answers"]]
            pred_scores.append(1.0 if pred_answer in gts else 0.0)
        return sum(pred_scores) / max(len(pred_scores), 1)


class STVQAANLSEvaluator:
    """Average Normalized Levenshtein Similarity of the lowercased,
    stripped strings; similarities under 0.5 count as 0."""

    def get_anls(self, s1: str, s2: str) -> float:
        s1 = s1.lower().strip()
        s2 = s2.lower().strip()
        if max(len(s1), len(s2)) == 0:
            return 0.0
        iou = 1 - levenshtein(s1, s2) / max(len(s1), len(s2))
        return iou if iou >= 0.5 else 0.0

    def eval_pred_list(self, pred_list) -> float:
        from mmf_tpu_torch.utils.native.editdist import anls_best

        pred_scores = [
            anls_best(e["pred_answer"].lower().strip(),
                      [gt.lower().strip() for gt in e["gt_answers"]])
            for e in pred_list
        ]
        return sum(pred_scores) / max(len(pred_scores), 1)


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n])
                   for i in range(len(tokens) - n + 1))


def corpus_bleu(list_of_references: Sequence[Sequence[Sequence[str]]],
                hypotheses: Sequence[Sequence[str]]) -> float:
    """Corpus BLEU-4 exactly as nltk's ``corpus_bleu`` computes it with
    its default arguments (see the module docstring)."""
    assert len(list_of_references) == len(hypotheses)
    orders = range(1, 5)
    numerators, denominators = Counter(), Counter()
    hyp_lengths = ref_lengths = 0
    for references, hypothesis in zip(list_of_references, hypotheses):
        for n in orders:
            counts = _ngrams(hypothesis, n)
            max_counts: Dict[tuple, int] = {}
            for reference in references:
                ref_counts = _ngrams(reference, n)
                for gram in counts:
                    max_counts[gram] = max(max_counts.get(gram, 0),
                                           ref_counts[gram])
            numerators[n] += sum(min(c, max_counts[g])
                                 for g, c in counts.items())
            denominators[n] += max(1, sum(counts.values()))
        hyp_len = len(hypothesis)
        hyp_lengths += hyp_len
        ref_lengths += min((len(r) for r in references),
                           key=lambda r: (abs(r - hyp_len), r))
    if hyp_lengths > ref_lengths:
        bp = 1.0
    elif hyp_lengths == 0:
        bp = 0.0
    else:
        bp = math.exp(1 - ref_lengths / hyp_lengths)
    if numerators[1] == 0:
        return 0.0
    precisions = []
    for n in orders:
        if numerators[n] != 0:
            precisions.append(numerators[n] / denominators[n])
        else:
            warnings.warn(
                f"\nThe hypothesis contains 0 counts of {n}-gram overlaps.\n"
                "Therefore the BLEU score evaluates to 0, independently of\n"
                "how many N-gram overlaps of lower order it contains.\n"
                "Consider using lower n-gram order or use "
                "SmoothingFunction()")
            precisions.append(sys.float_info.min)
    return bp * math.exp(math.fsum(0.25 * math.log(p) for p in precisions))


class TextCapsBleu4Evaluator:
    """Corpus BLEU-4 of the predicted captions against their reference
    captions, each lowercased and split into word and punctuation tokens
    (JAX's tokenization; the reference's PTB tokenizer is not used)."""

    @staticmethod
    def _tok(s: str) -> List[str]:
        return re.findall(r"\w+|[^\w\s]", s.lower())

    def eval_pred_list(self, pred_list) -> float:
        refs = [[self._tok(a) for a in e["gt_answers"]] for e in pred_list]
        hyps = [self._tok(e["pred_answer"]) for e in pred_list]
        return float(corpus_bleu(refs, hyps))
