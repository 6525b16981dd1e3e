"""Prompt battery of the STVQA synthesis pipeline (the port's copy of
``spatialthinker_tpu/data_gen/prompts.py``, text for text: the generated
questions and the answer format the ``spatial_sgg`` reward parses are the
same whichever package builds the data).

The question-generation prompt carries the full few-shot battery
(task-category taxonomy, salience rules, live $DATA_STATS$ feedback,
canonical relation table, question patterns, worked examples, generation
steps); QUESTION_PREFIX is the structured <observe>/<scene>/<think>/<answer>
answer format with its worked example; the validation prompt asks a grader
model for the bare option letter.
"""

CATEGORIES = [
    "relation", "reach", "size", "orientation", "instance_location",
    "depth", "distance", "count", "existence",
]
LEVELS = ["easy", "medium", "hard"]

QUESTION_GEN_PROMPT = """You are a spatial-QA builder: a specialist in writing question-answer pairs that genuinely test visual-spatial reasoning, from ground-truth scene graphs.

----------------------------------------

TASK CATEGORIES
Every category matters equally — pick based on the data statistics below:

1. relation          - spatial predicate between two objects (above, behind, near, on top of ...)
2. reach             - reaching / touching / holding / interaction between objects
3. size              - comparative size (larger/smaller, taller/shorter)
4. orientation       - direction of one object seen from another's perspective
5. instance_location - where a single object sits in the image frame (top-left corner, centre ...)
6. depth             - which of two objects is closer to the camera
7. distance          - which object is closer to a referent object
8. count             - how many instances of an object class exist (USE SPARINGLY)
9. existence         - whether an object X with property Y is present (Yes/No)

Choose the highest-value category that is both supported by the graph and passes the salience rules. Prioritize categories with LOW percentages in the data statistics (those are under-represented).

CRITICAL: use ONLY objects and relationships that literally appear in the provided scene graph. Never invent objects, predicates, or relations. Build questions around entries in the "relations" list whenever possible, preferring objects that participate in explicit relations.

----------------------------------------

SALIENCE RULES (filter candidate triples first)

1. Reject low-salience objects/parts: names that denote parts, decorations or text (logo, label, sticker, emblem, pattern, text, sign, face, screen, patch, hair, sleeve, button, window, door-handle ...); clothing/body-wear relations (shirt-person, hat-man, shoe-foot); body-part relations that are trivially true (ear-head, arm-person); any relation whose answer is obvious to any human.
2. Reject common-sense default states: "leaf on tree", "wheel on car", "man wearing shirt", "door on house" — keep only meaningful, scene-specific spatial interactions.
3. Prefer inter-object relations where subject and object are different high-level categories (person vs bench, car vs tree) with a non-trivial spatial interaction.
4. Deprioritize possession/material/containment predicates unless nothing better exists (containment like "ball inside the box" is fine).
5. Count questions: only when >= 3 clearly countable instances exist, the category is significantly under-represented, AND the instances are not split across synonyms (person/guy/man/people/skier count as ONE class). Never count hard-to-count crowds.
6. instance_location: only when exactly ONE instance of the object type (including synonyms) exists in the image.
7. Among surviving triples, prefer the one with the largest combined subject+object bounding-box area (bigger tends to be more central).
8. Never generate a count question when instances are too numerous or synonym classes would have to be merged ambiguously.

----------------------------------------

DATA STATS SNAPSHOT (refreshed automatically):

$DATA_STATS$

USE THESE STATS TO DRIVE SELECTION:
1. Category: strongly prioritize the lowest-percentage categories; aim for a uniform spread over all 9; avoid repeating the previous category when an alternative exists.
2. Difficulty: target 40% easy, 40% medium, 20% hard; prioritize whichever levels are below target; avoid repeating the previous level when possible.

----------------------------------------

INPUT (example structure — real data follows at the end):
{
"objects": [
{"id":"railing.1","bbox":[114,329,458,415]},
...
],
"relations": [
{"subject":"flower.4","predicate":"in","object":"pot.7"},
{"subject":"clock.2","predicate":"with","object":"face.3"}
]
}

----------------------------------------

OUTPUT (one JSON object, nothing else):
{
"question" : <str>,   # use ONLY object-type names, never IDs
"options"  : [<str>], # 2-4 MCQ options, correct answer included
"answer"   : <str>,   # letter (A, B, C, or D) of the correct option
"category" : "relation" | "reach" | "size" | "orientation" | "instance_location" | "depth" | "distance" | "count" | "existence",
"level"    : "easy" | "medium" | "hard",
"rating"   : <int>    # 1-10: how much this question improves spatial intelligence
}
Always emit exactly these keys, valid JSON, no markdown fences.

Difficulty criteria:
- easy: simple clear relationships, fully visible objects, basic spatial concepts, minimal reasoning.
- medium: more complex relationships, partial occlusion, several objects to weigh, closer observation needed.
- hard: multi-step spatial reasoning, heavy occlusion, subtle distance/position distinctions, unusual perspectives.

MCQ format: 2-4 options labeled (A)-(D); distractors must be plausible in this scene; the answer field is the correct option's letter.

Answer content per category:
- relation          -> predicate token or close synonym ("behind", "in back of")
- reach             -> interaction word ("holding", "touching")
- size              -> comparative term ("larger", "taller")
- orientation       -> directional term from the stated perspective ("in front", "to the left")
- instance_location -> frame position term ("top left corner", "centre")
- depth / distance  -> the object-type name that is closer ("bus")
- count             -> integer string ("3")
- existence         -> "yes" or "no"
No IDs, no extra words; predicate synonyms allowed.

----------------------------------------

CANONICAL RELATION TABLE (for "relation"):
REL_ABOVE_BELOW       : above, over, beneath, under, below
REL_LEFT_RIGHT        : left of, right of, left, right
REL_FRONT_BEHIND      : behind, in front of, on back of, at the back of
REL_INSIDE_CONTAINING : in, inside, part of, belonging to, flying in, walking in, consist, contain
REL_ON_SUPPORTING     : on, on top of, sitting on, standing on, lying on, laying on, parked on, mounted on, riding, walking on, growing on, hanging from
REL_TOUCHING_ADJACENT : touching, holding, attached to, leaning against, next to, beside, against, carrying, reached
REL_NEAR_FAR          : near, far from, alongside, far, far away, close
REL_BETWEEN           : between, in between
REL_ACROSS_ALONG      : across, along
REL_FACING_ORIENTATION: facing, looking at, watching, facing towards, facing away
REL_SIZE              : bigger, smaller, taller, shorter
REL_MISC              : parallel to, perpendicular to, across from, and, at, for, from, to, surrounding, outside

----------------------------------------

QUESTION PATTERNS (pick ONE):
relation          : "Where is {subject} with respect to {object}?"
instance_location : "In which part of the image is the {object} located?" (single-instance rule applies)
depth             : "Which is closer to the camera, the {A} or the {B}?"
distance          : "Which object is closer to the {ref}, the {A} or the {B}?"
count             : "How many {object_type_plural} are there in the image?" (synonym-merge rule applies)
existence         : "Is there a {X} {predicate} a {Y} in the picture?"
orientation       : "From the {ref}'s perspective, which direction is the {A}?" / "If I stand at the {ref}'s position facing where it faces, is the {A} in front of me or behind me?"

----------------------------------------

WORKED EXAMPLES (never include these in your answer)

Example A - relation (easy). Input: "man.3 sitting on bench.1"
{
  "question": "Where is the man with respect to the bench?",
  "options": ["(A) sitting on", "(B) standing behind", "(C) lying under"],
  "answer": "A",
  "category": "relation",
  "level": "easy",
  "rating": 7
}

Example B - instance_location (medium). Input: object "flag.2" centred at (0.15 W, 0.12 H)
{
  "question": "In which part of the image is the flag located?",
  "options": ["(A) top left corner", "(B) center", "(C) bottom right corner", "(D) top right corner"],
  "answer": "A",
  "category": "instance_location",
  "level": "medium",
  "rating": 6
}

Example C - depth (hard). Input: "bookshelf.2" and "table.5", partially occluded
{
  "question": "Which is closer to the camera, the bookshelf or the table?",
  "options": ["(A) bookshelf", "(B) table", "(C) they are at the same distance"],
  "answer": "B",
  "category": "depth",
  "level": "hard",
  "rating": 8
}

Example D - count (easy). Input: 5 visible cars
{
  "question": "How many cars are there in the image?",
  "options": ["(A) 3", "(B) 4", "(C) 5", "(D) 6"],
  "answer": "C",
  "category": "count",
  "level": "easy",
  "rating": 5
}

Example E - reach (medium). Input: "woman.2 holding bottle.3"
{
  "question": "What is the woman doing with the bottle?",
  "options": ["(A) holding", "(B) throwing", "(C) drinking from"],
  "answer": "A",
  "category": "reach",
  "level": "medium",
  "rating": 7
}

Example F - relation (easy). Input triple: "book.1 on shelf.2"
{
  "question": "Where is the book with respect to the shelf?",
  "options": ["(A) on", "(B) under", "(C) beside"],
  "answer": "A",
  "category": "relation",
  "level": "easy",
  "rating": 6
}

Example G - orientation (hard). Input: "person.2" facing away from "dog.4", occluded by "table.1"
{
  "question": "From the person's perspective, which direction is the dog?",
  "options": ["(A) in front", "(B) behind", "(C) to the left", "(D) to the right"],
  "answer": "B",
  "category": "orientation",
  "level": "hard",
  "rating": 9
}

Example H - distance (hard). Input: "ball.3" nearer to "cat.1" than "toy.5", needing careful analysis
{
  "question": "Which object is closer to the cat, the ball or the toy?",
  "options": ["(A) ball", "(B) toy", "(C) they are equidistant"],
  "answer": "A",
  "category": "distance",
  "level": "hard",
  "rating": 8
}

----------------------------------------

GENERATION STEPS
1. Filter relations & objects by the SALIENCE RULES; never invent data.
2. Balance: all 9 categories equally important; explicitly prioritize under-represented ones (especially orientation, depth, distance, size, existence when low); limit count questions; target 40/40/20 easy/medium/hard and prioritize under-represented levels; avoid trivial relations (body parts to owners, inherent parts, person-on-ground defaults). The data statistics are your PRIMARY selection signal.
3. Assign difficulty per the criteria above.
4. Select the triple(s) or object set for the chosen task, preferring objects with explicit relations.
5. Compose the question from the matching pattern using clean object-type names only.
6. Set answer, category, and level per the rules.
7. Return ONLY the JSON object (no markdown, no IDs).
8. Re-check the output against the target distributions and the stats snapshot.
9. For count questions: count from the objects list only; merge synonyms (person/guy/man/people/skier); skip when instances are too numerous; never count object types absent from the list.

----------------------------------------
Now process the following scene graph:
Scene Graph data:
"""

QUESTION_PREFIX = '''<image> You are a vision-language assistant tasked with answering a question by observing an image, identifying relevant objects and relationships, and reasoning through a structured scene graph.

Your task is to:
- Identify objects of interest relevant to answering the given question, and any relevant relationships between these objects, and localise these objects in the image.
- Generate a visualisation of the relevant objects and any relationships as a structured scene graph following the format shared below. This scene graph should serve as a structured, mind-mapped knowledge representation of the key elements required to answer the given question. Focus only on objects and relationships that are directly pertinent to reasoning about the question.
- Use your observations from the given image and the visualised structured scene graph, to deeply think through the question before generating the final answer.
- In the scene graph, assign each relevant object a unique ID in the format "object_name.number" (e.g. "boy.1", "plate.2"). Provide bounding boxes for relevant objects in pixel coordinates as [x1, y1, x2, y2]
- Format your output using the following structure:
<observe>
{{Describe the scene depicted in the image covering the relevant objects. Based on the question, what specific relevant objects of the image should you focus on?}}
</observe>
<scene>
{{
"objects": [
{{"id": "object_name.1", "bbox": [x1, y1, x2, y2]}},
...
],
"relationships": [
{{"subject": "object_name.1", "predicate": "predicate_word", "object": "object_name.2"}},
...
]
}}
</scene>
<think>
{{Reflect on the scene graph, observations, and reason through the question using the identified relevant objects and their relationships. Walk through your thought process step-by-step, as an internal monologue. Justify how the visual information leads to your final answer, and explain the reasoning path you followed to arrive at it.}}
</think>
<answer>
{{Your final answer}}
</answer>

Example:
Q. Where is the man with respect to the bike?
Options: (A) behind (B) in front of (C) beside (D) on top of

<observe>
The image shows an outdoor scene with a man standing on a paved surface near a bicycle. The man appears upright and facing forward, while the bicycle is parked sideways in the foreground. The relevant objects are the man and the bike: the man sits toward the upper-left of the frame, the bicycle fills much of the lower half, and the man's legs are partially occluded by the bicycle — suggesting he stands behind it in depth from the viewer's perspective.
</observe>
<scene>
{{
"objects": [
{{"id": "bike.1", "bbox": [0, 272, 310, 551]}},
{{"id": "man.1", "bbox": [0, 165, 38, 278]}}
],
"relationships": [
{{"subject": "man.1", "predicate": "behind", "object": "bike.1"}}
]
}}
</scene>
<think>
Looking at the visual image and the scene graph, I can see the man is standing behind the bicycle. The relationship in the scene graph confirms this with "man.1 behind bike.1". Among the options: (A) behind, (B) in front of, (C) beside, (D) on top of - the correct answer is "behind".
</think>
<answer>
(A) behind
</answer>

Image size: ({W} x {H})

Now answer the following question:
'''

VALIDATION_PROMPT = """Answer the following multiple choice question about the image.

Question: {question}

Options:
{options}

Reply with only the letter of the correct answer (A, B, C, or D)."""
