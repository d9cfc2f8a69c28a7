"""BLIP-2 prompt / label plumbing (the port's own copy of the JAX
package's ``models/vlm/prompts.py``; ``tests/test_torch_hygiene.py`` holds
the two together).

The knowledge prompt and the decoded-answer matcher are DATA the reference
checkpoints were trained against, reproduced exactly:
  * prompt template — reference blip_2_training.py:59-64 (including its
    embedded newline+indentation whitespace, which the tokenizer saw);
  * label mapping folder->answer word with TTR -> "Yellow"
    (blip_2_training.py:72-75);
  * ``find_closest_string`` — 3-char prefix shortcuts then difflib
    (blip_2_training.py:118-134).
"""

from __future__ import annotations

import difflib
import re

# order matters: index == class index used by the reference metrics
ANSWER_WORDS = ["Blue", "Green", "Black", "Yellow"]

# class-folder name (sorted: black, blue, green, ttr) -> answer word
FOLDER_TO_ANSWER = {"black": "Black", "blue": "Blue", "green": "Green",
                    "ttr": "Yellow", "TTR": "Yellow"}

# answer word -> class index in OUR sorted-folder convention
ANSWER_TO_CLASS_IDX = {"Black": 0, "Blue": 1, "Green": 2, "Yellow": 3}

PROMPT_TEMPLATE = '''Question: Knowing that the Blue label is recyclable,
        Green label is for composting,
        Black label is non-recyclable,
        and Yellow label needs to be recycled at a specific location,
        which label does this {text} belong to? Answer:'''

MAX_PROMPT_TOKENS = 100  # blip_2_training.py:66 (left-padded to 100)


def build_prompt(item_text: str) -> str:
    return PROMPT_TEMPLATE.format(text=item_text)


def prompt_text_from_path(path: str) -> str:
    """Filename -> prompt text (blip_2_training.py:56-57: digits stripped,
    extension dropped, underscores to spaces)."""
    name = path.split("/")[-1]
    name = re.sub(r"\d+", "", name)[:-4]
    return name.replace("_", " ").strip()


def find_closest_string(target: str, string_list=ANSWER_WORDS) -> str:
    match = re.search(r"Answer:\s*(.*)", target)
    if match:
        target = match.group(1)
    if len(target) <= 3:
        if "Yel" in target:
            return string_list[3]
        if "Blu" in target:
            return string_list[0]
        if "Gre" in target:
            return string_list[1]
        if "Bla" in target:
            return string_list[2]
    closest = difflib.get_close_matches(target, string_list, n=1)
    return closest[0] if closest else string_list[0]
