"""Render a tokenizer's chat template as transformers' ``apply_chat_template``
does (``tokenize=False``), with ``jinja2`` and without ``transformers``.

The environment is transformers': jinja2's
``ImmutableSandboxedEnvironment`` with ``trim_blocks`` and
``lstrip_blocks``, the loop controls (``break``,
``continue``), a ``tojson`` filter that keeps non-ASCII text, and the
globals ``raise_exception`` (a ``TemplateError``) and ``strftime_now``
(the host's local time). The template sees ``messages``, ``tools`` and
``documents`` (None), ``add_generation_prompt`` and the tokenizer's
special tokens (``bos_token``, ``eos_token``, ...). Templates that mark
assistant turns with ``{% generation %}`` are not read.
"""

from __future__ import annotations

import json
from datetime import datetime
from typing import Dict, List, Optional


def _raise_exception(message):
    import jinja2

    raise jinja2.exceptions.TemplateError(message)


def _tojson(x, ensure_ascii=False, indent=None, separators=None,
            sort_keys=False):
    return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent,
                      separators=separators, sort_keys=sort_keys)


def _strftime_now(fmt):
    return datetime.now().strftime(fmt)


def compile_template(source: str):
    """The jinja2 template of `source` in transformers' environment."""
    import jinja2.ext
    from jinja2.sandbox import ImmutableSandboxedEnvironment

    env = ImmutableSandboxedEnvironment(
        trim_blocks=True, lstrip_blocks=True,
        extensions=[jinja2.ext.loopcontrols])
    env.filters["tojson"] = _tojson
    env.globals["raise_exception"] = _raise_exception
    env.globals["strftime_now"] = _strftime_now
    return env.from_string(source)


def render_chat(source: str, messages: List[Dict[str, str]], *,
                add_generation_prompt: bool = False,
                special_tokens: Optional[Dict[str, str]] = None) -> str:
    """`messages` ([{"role", "content"}, ...]) rendered by the template
    `source` with the tokenizer's `special_tokens` as variables."""
    return compile_template(source).render(
        messages=messages, tools=None, documents=None,
        add_generation_prompt=add_generation_prompt,
        **(special_tokens or {}))
