"""Benchmark dataset registry (the port's own copy of
``spatialthinker_tpu/eval/registry.py``): the 30+ spatial and multimodal
evaluation sets of SpatialThinker's harness (its ``evaluation/evals.py``), with
the same names, HF paths, field mappings and per-task sample counts."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union


@dataclass(frozen=True)
class DatasetSpec:
    name: str                      # HF hub path
    split: str
    image_field: Union[str, List[str], None]
    response_field: str
    instruction_field: Optional[str] = None
    subset: Optional[str] = None
    choices_field: Optional[str] = None
    options_field: Optional[str] = None
    task_field: Optional[str] = None
    tasks: Optional[Dict[str, int]] = None


def _blink(subset: str, images=1) -> DatasetSpec:
    image_field = "image_1" if images == 1 else [f"image_{i+1}" for i in range(images)]
    return DatasetSpec(
        name="BLINK-Benchmark/BLINK", split="val", subset=subset,
        image_field=image_field, instruction_field="prompt",
        response_field="answer", choices_field="choices",
    )


REGISTRY: Dict[str, DatasetSpec] = {
    "mmvp": DatasetSpec("hunarbatra/MMVP", "train", "image", "label", "text"),
    "spatialbench": DatasetSpec(
        "hunarbatra/SpatialBench", "train", "image", "answer", "text",
        task_field="category",
        tasks={"existence": 40, "reach": 40, "size": 40, "positional": 34, "counting": 20},
    ),
    "realworld_qa": DatasetSpec("visheratin/realworldqa", "test", "image", "answer", "question"),
    "blink-object": _blink("Object_Localization"),
    "blink-counting": _blink("Counting"),
    "blink-spatial": _blink("Spatial_Relation"),
    "blink-depth": _blink("Relative_Depth"),
    "blink-multi-view": _blink("Multi-view_Reasoning", images=2),
    "blink-jigsaw": _blink("Jigsaw", images=3),
    "spatialreasoner": DatasetSpec(
        "hunarbatra/SpatialReasonerEval", "train", "image", "answer", "prompt",
        choices_field="choices", task_field="task", tasks={"Depth": 600, "Distance": 600},
    ),
    "3dsrbench": DatasetSpec(
        "hunarbatra/3DSRBench", "test", "image", "answer", "prompt",
        choices_field="choices", task_field="task",
        tasks={"height": 350, "location": 875, "orientation": 525, "multi_object": 875},
    ),
    "3dsrbench_full": DatasetSpec(
        "hunarbatra/3DSRBench-Full", "test", "image", "answer", "prompt",
        choices_field="choices", task_field="task",
        tasks={"height": 350, "location": 875, "orientation": 525, "multi_object": 875},
    ),
    "robospatial": DatasetSpec(
        "hunarbatra/RoboSpatial-Home", "train", ["image", "depth_image"], "answer", "prompt",
        choices_field="options", task_field="category",
        tasks={"configuration": 123, "compatibility": 105},
    ),
    "robospatial_rgb": DatasetSpec(
        "hunarbatra/RoboSpatial-Home", "train", "image", "answer", "prompt",
        choices_field="options", task_field="category",
        tasks={"configuration": 123, "compatibility": 105},
    ),
    "lego": DatasetSpec(
        "hunarbatra/LEGO-Puzzles", "train", "image", "answer", "prompt",
        choices_field="choices", task_field="category",
        tasks={
            "height": 100, "adjacency": 100, "rotation": 100, "multi_view": 100,
            "rotation_status": 100, "position": 100, "next_step": 100, "outlier": 100,
            "dependency": 100, "backwards": 100,
        },
    ),
    "mathvista_mcq": DatasetSpec(
        "hunarbatra/MathVista_MCQ", "testmini", "image", "answer", "prompt",
        choices_field="choices",
    ),
    "mathverse_vision_mcq": DatasetSpec(
        "hunarbatra/MathVerse_Vision_MCQ", "testmini", "image", "answer", "prompt",
        choices_field="choices",
    ),
    "stvqa": DatasetSpec(
        "hunarbatra/STVQA-7K", "val", "images", "answer_only", "question_with_options",
        choices_field="options",
    ),
    "cv-bench": DatasetSpec(
        "nyu-visionx/CV-Bench", "test", "image", "answer", "prompt", subset="default",
        choices_field="choices", task_field="task",
        tasks={"Count": 788, "Relation": 650, "Distance": 600, "Depth": 600},
    ),
    "cv-bench-2D": DatasetSpec(
        "nyu-visionx/CV-Bench", "test", "image", "answer", "prompt", subset="2D",
        choices_field="choices", task_field="task", tasks={"Count": 788, "Relation": 650},
    ),
    "cv-bench-3D": DatasetSpec(
        "nyu-visionx/CV-Bench", "test", "image", "answer", "prompt", subset="3D",
        choices_field="choices", task_field="task", tasks={"Distance": 600, "Depth": 600},
    ),
    "mmmu_pro": DatasetSpec(
        "MMMU/MMMU_Pro", "test", "image_1", "answer", "question",
        subset="standard (4 options)", choices_field="options", task_field="topic_difficulty",
        tasks={"Easy": 528, "Medium": 801, "Hard": 401},
    ),
    "mmmu_pro_vision_only": DatasetSpec(
        "MMMU/MMMU_Pro", "test", "image", "answer", None, subset="vision",
        choices_field="options",
    ),
    "mmmu-pro-vision": DatasetSpec(
        "MMMU/MMMU_Pro", "test", "image", "answer", None, subset="vision",
        choices_field="options",
    ),
    "mathvista": DatasetSpec(
        "AI4Math/MathVista", "testmini", "decoded_image", "answer", "query",
        choices_field="choices",
    ),
    "mathverse": DatasetSpec(
        "AI4Math/MathVerse", "testmini", "image", "answer", "query_cot", subset="testmini",
    ),
    "mathvision": DatasetSpec(
        "MathLLMs/MathVision", "test", "decoded_image", "answer", "question",
        options_field="options",
    ),
    "sftseed": DatasetSpec("ydeng9/sft_seed", "train", "decoded_image", "answer", "problem"),
    "hallusionbench": DatasetSpec(
        "lmms-lab/HallusionBench", "image", "image", "gt_answer", "question",
    ),
    "emma-math": DatasetSpec(
        "hunarbatra/EMMA_MATH", "test", "image_1", "answer", "prompt",
        choices_field="choices", task_field="category",
        tasks={
            "3D Spatial Simulation": 275, "2D Transformation": 266, "Path Tracing": 127,
            "Multi-hop Visual Object Counting": 124, "Pattern Inference": 100,
        },
    ),
    "emma-chem": DatasetSpec(
        "luckychao/EMMA", "test", [f"image_{i+1}" for i in range(5)], "answer", "question",
        subset="Chemistry", options_field="options",
    ),
    "emma-code": DatasetSpec(
        "luckychao/EMMA", "test", [f"image_{i+1}" for i in range(5)], "answer", "question",
        subset="Coding", options_field="options",
    ),
    "emma-physics": DatasetSpec(
        "luckychao/EMMA", "test", [f"image_{i+1}" for i in range(5)], "answer", "question",
        subset="Physics", options_field="options",
    ),
}


def get_dataset_spec(name: str) -> DatasetSpec:
    if name not in REGISTRY:
        raise KeyError(f"unknown benchmark {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]
