"""Guided (JSON) decoding: sampling constrained to valid-JSON continuations
(counterpart of `dashinfer_tpu.engine.guided`, plain Python and numpy).

Reference: `FormatEnforcer`, a vendored lm-format-enforcer C++ port hooked
into GenerateOp when response_format={"type": "json_object"}, masking the
logits to the allowed token set each step (csrc/.../format_enforcer.h:24-110,
format_enforcer.cpp:334-357; docs/sphinx/llm/guided_decoding.rst).

The token-set computation stays on the host: a character-level JSON prefix
acceptor and a trie over the tokenizer's vocabulary give a [vocab] bool
mask that the engine copies to the card, where the guided step masks the
logits before sampling. Masks are cached by parser state, so steady-state
decoding mostly reuses sets computed before.
"""

from typing import Dict, List, Optional, Tuple

import numpy as np

from dashinfer_tpu_torch.utils import get_logger

logger = get_logger("guided")

# -- incremental JSON prefix acceptor ----------------------------------------
# State = (stack string, mode, extra). Stack chars: '{' in-object, '[' in-array.
# Modes: V=expect value, K=expect key-string-start, C=expect ':' after key,
#        E=expect ',' or close, S=in-string, X=escape-in-string, N=in-number,
#        L=in-literal, D=done
_WS = " \t\n\r"
_DIGITS = "0123456789"


class JsonState:
    __slots__ = ("stack", "mode", "lit", "lit_pos", "num", "in_key")

    def __init__(self, stack="", mode="V0", lit="", lit_pos=0, num="",
                 in_key=False):
        self.stack = stack
        self.mode = mode
        self.lit = lit
        self.lit_pos = lit_pos
        self.num = num
        self.in_key = in_key

    def key(self) -> Tuple:
        return (self.stack, self.mode, self.lit, self.lit_pos, self.num,
                self.in_key)

    def clone(self) -> "JsonState":
        return JsonState(self.stack, self.mode, self.lit, self.lit_pos,
                         self.num, self.in_key)


def _num_can_end(num: str) -> bool:
    if not num or num[-1] not in _DIGITS:
        return False
    return True


def advance_char(st: JsonState, c: str) -> bool:
    """Mutate st by consuming c; False if c is not a legal continuation."""
    m = st.mode
    if m == "D":
        return False
    if m == "S":  # inside string
        if c == "\\":
            st.mode = "X"
            return True
        if c == '"':
            if st.in_key:
                st.mode = "C"
                st.in_key = False
            else:
                st.mode = "E" if st.stack else "D"
            return True
        return c not in "\n\r" and (ord(c) >= 0x20)
    if m == "X":  # escape char
        if c in '"\\/bfnrtu':
            st.mode = "S"
            return True
        return False
    if m == "L":  # literal true/false/null
        if st.lit_pos < len(st.lit) and c == st.lit[st.lit_pos]:
            st.lit_pos += 1
            if st.lit_pos == len(st.lit):
                st.mode = "E" if st.stack else "D"
            return True
        return False
    if m == "N":  # number
        n = st.num
        ok = False
        if c in _DIGITS:
            if n.endswith("0") and len(n.lstrip("-")) == 1 and \
                    "." not in n and "e" not in n and "E" not in n:
                ok = False  # no leading zeros
            else:
                ok = True
        elif c == ".":
            ok = n and n[-1] in _DIGITS and "." not in n and \
                "e" not in n and "E" not in n
        elif c in "eE":
            ok = n and n[-1] in _DIGITS and "e" not in n and "E" not in n
        elif c in "+-":
            ok = n and n[-1] in "eE"
        if ok:
            st.num = n + c
            return True
        # number ends; c must be a delimiter
        if not _num_can_end(n):
            return False
        st.mode = "E" if st.stack else "D"
        st.num = ""
        return advance_char(st, c)
    # structural modes
    if c in _WS:
        return True
    if m in ("V0", "V"):  # expect a value (V0 = top level: object only is
        # the reference behavior for json_object, but accept any JSON value
        # except at the very top where we require an object/array start)
        top = (m == "V0")
        if c == "{":
            st.stack += "{"
            st.mode = "K"
            return True
        if c == "[":
            st.stack += "["
            st.mode = "V"
            return True
        if top:
            return False
        if c == '"':
            st.mode = "S"
            st.in_key = False
            return True
        if c in "-0123456789":
            st.mode = "N"
            st.num = c
            return True
        for lit in ("true", "false", "null"):
            if c == lit[0]:
                st.mode = "L"
                st.lit = lit
                st.lit_pos = 1
                return True
        return False
    if m == "K":  # expect key string or '}'
        if c == '"':
            st.mode = "S"
            st.in_key = True
            return True
        if c == "}" and st.stack.endswith("{"):
            st.stack = st.stack[:-1]
            st.mode = "E" if st.stack else "D"
            return True
        return False
    if m == "C":  # expect ':'
        if c == ":":
            st.mode = "V"
            return True
        return False
    if m == "E":  # after a value inside a container
        if not st.stack:
            return False
        if c == ",":
            st.mode = "K" if st.stack.endswith("{") else "V"
            return True
        if c == "}" and st.stack.endswith("{"):
            st.stack = st.stack[:-1]
            st.mode = "E" if st.stack else "D"
            return True
        if c == "]" and st.stack.endswith("["):
            st.stack = st.stack[:-1]
            st.mode = "E" if st.stack else "D"
            return True
        return False
    # "]" closing an empty array arrives via mode V with stack "["
    return False


def advance_str(st: JsonState, s: str) -> bool:
    for c in s:
        if not advance_char(st, c):
            return False
    return True


def is_complete(st: JsonState) -> bool:
    return st.mode == "D"


# -- token trie over the vocabulary ------------------------------------------

class TokenTrie:
    """Prefix trie of token STRINGS; built once per tokenizer."""

    def __init__(self, vocab_strings: List[str]):
        self.root: Dict = {}
        for tid, s in enumerate(vocab_strings):
            if not s:
                continue
            node = self.root
            for ch in s:
                node = node.setdefault(ch, {})
            node.setdefault(None, []).append(tid)


def build_vocab_strings(tokenizer) -> List[str]:
    """Decoded text of each token id (byte-level BPEs need convert via
    decode of single ids)."""
    n = len(tokenizer)
    try:
        # one Rust-side call on fast tokenizers (~100x the Python loop)
        return tokenizer.batch_decode([[tid] for tid in range(n)])
    except Exception:
        return [tokenizer.decode([tid]) for tid in range(n)]


class JsonFormatEnforcer:
    """Per-request guided-decoding state (reference FormatEnforcer)."""

    # class-level cache shared across requests for one tokenizer
    _shared: Dict[int, Tuple[TokenTrie, List[str], int]] = {}

    def __init__(self, tokenizer, eos_token_id: int, vocab_size: int):
        key = id(tokenizer)
        if key not in self._shared:
            strings = build_vocab_strings(tokenizer)
            self._shared[key] = (TokenTrie(strings), strings, vocab_size)
            logger.info("built token trie over %d tokens", len(strings))
        self.trie, self.strings, self.vocab_size = self._shared[key]
        self.eos = eos_token_id
        self.state = JsonState()
        self._mask_cache: Dict[Tuple, np.ndarray] = {}

    def allowed_mask(self) -> np.ndarray:
        """bool [vocab]: tokens that keep the output a valid JSON prefix."""
        sig = self.state.key()
        hit = self._mask_cache.get(sig)
        if hit is not None:
            return hit
        mask = np.zeros((self.vocab_size,), bool)
        stack = [(self.trie.root, self.state)]
        while stack:
            node, st = stack.pop()
            for ch, child in node.items():
                if ch is None:
                    for tid in child:
                        if tid < self.vocab_size:
                            mask[tid] = True
                    continue
                st2 = st.clone()
                if advance_char(st2, ch):
                    stack.append((child, st2))
        if is_complete(self.state) and 0 <= self.eos < self.vocab_size:
            mask[self.eos] = True
        self._mask_cache[sig] = mask
        return mask

    def advance(self, token_id: int) -> bool:
        """Consume a sampled token; returns False if it broke the format
        (shouldn't happen when the mask was applied)."""
        if token_id == self.eos:
            return True
        s = self.strings[token_id] if token_id < len(self.strings) else ""
        return advance_str(self.state, s)

    @property
    def complete(self) -> bool:
        return is_complete(self.state)
