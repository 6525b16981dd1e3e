"""Evaluation prompt templates (the port's own copy of
``spatialthinker_tpu/eval/templates.py``; SpatialThinker's
``evaluation/templates.py`` and ``format_instruction``): the same template
names and text, so a trained model sees the prompts it was trained on."""

from __future__ import annotations

from typing import List, Optional, Tuple

SPATIAL_THINKER_TEMPLATE = (
    "You FIRST observe the image in <observe> </observe> tags, then visualise "
    "the relevant scene graph in <scene> </scene> tags, followed by thinking "
    "about the reasoning process as an internal monologue within <think> "
    "</think> tags and then provide the final answer. The final answer MUST BE "
    "put within <answer> </answer> tags, and only return the final choice "
    "including the correct option and answer within the answer tags, e.g., "
    "<answer> ({correct_option}) {correct_answer} </answer>.\n\n"
    "Image size: {Width} x {Height}"
)

SPATIAL_THINKER_TEMPLATE_FULL = """<image> You are a vision-language assistant. Answer the question by observing the image, grounding the relevant objects, and reasoning over a structured scene graph.

Steps:
- Pick out only the objects (and any relationships between them) that matter for the question, and localise each object in the image.
- Render them as a scene graph in the exact JSON structure below — it is your working spatial map for the question. Give every object a unique id of the form "object_name.number" (e.g. "cup.1", "table.2") and a pixel-coordinate bounding box [x1, y1, x2, y2].
- Then reason through the question step by step using your observations and the scene graph before committing to an answer.

Output format:
<observe>
{What does the scene show? Which objects are relevant to this question?}
</observe>
<scene>
{
  "objects": [
    {"id": "object_name.1", "bbox": [x1, y1, x2, y2]},
    ...
  ],
  "relationships": [
    {"subject": "object_name.1", "predicate": "predicate_word", "object": "object_name.2"},
    ...
  ]
}
</scene>
<think>
{Step-by-step reasoning over the scene graph and observations, justifying how the visual evidence leads to the answer.}
</think>
<answer>
{Your final answer}
</answer>
"""

REASONING_HINT = (
    "You FIRST think about the reasoning process as an internal monologue and "
    "then provide the final answer. The reasoning process MUST BE enclosed "
    "within <think> </think> tags. The final answer MUST BE put within "
    "<answer> </answer> tags, and only return the final choice including the "
    "correct option and answer within the answer tags, e.g., "
    "<answer> ({correct_option}) {correct_answer} </answer>."
)

REASONING_END_HINT = (
    "First output the thinking process in <think> </think> tags, followed by "
    "the final answer within <answer> </answer> tags."
)

OPTION_LETTERS = [chr(65 + i) for i in range(10)]


def _choice_list(options: List[str]) -> str:
    return "\n".join(f"({OPTION_LETTERS[i]}) {opt}" for i, opt in enumerate(options))


def format_instruction(
    instruction: str,
    options: Optional[List[str]] = None,
    choices: Optional[List[str]] = None,
    image_size: Optional[Tuple[int, int]] = None,
    template: str = "reasoning",
) -> str:
    """template in {vision, yes_no, reasoning, no_reasoning, reasoning_end,
    spatial_thinker, default}."""
    if template == "vision":
        hint = "Hint: Please answer the question shown in the image."
        if options:
            hint += " Provide the correct option letter, e.g., A, B, C, D, E, at the end."
            return f"{hint}\nChoices:\n{_choice_list(options)}"
        return hint
    if template == "yes_no":
        return (
            "Hint: Please answer the question requiring an answer of yes or no."
            f"\nQuestion: {instruction}"
        )
    if template == "reasoning":
        return f"{REASONING_HINT}\nQuestion: {instruction}"
    if template == "no_reasoning":
        return f"Question: {instruction}"
    if template == "reasoning_end":
        return f"Question: {instruction}\n{REASONING_END_HINT}"
    if template == "spatial_thinker":
        width, height = image_size if image_size else (0, 0)
        question = f"({width} x {height})\n\nNow answer the following question:\n{instruction}"
        return f"{SPATIAL_THINKER_TEMPLATE}\n{question}"
    # default: plain QA with optional choices
    if options:
        hint = (
            "Hint: Please answer the question and provide the correct option "
            "letter, e.g., A, B, C, D, E, at the end."
        )
        return f"{hint}\nQuestion: {instruction}\nChoices:\n{_choice_list(options)}"
    return f"Hint: Please answer the question requiring an answer.\nQuestion: {instruction}"
