"""Natural-language prompt generation for HA-ViD action codes (the port's
copy of ``fact_clip_tpu/data/text_prompts.py``; pure Python, copied so that
the port imports nothing of the JAX package, and held equal to it by
``tests/test_torch_port_clip.py``).

HA-ViD labels pack verb (1 char) + manipulated object (2) + target object (2)
+ tool (2); e.g. ``sshc1dh`` -> "a person screws a hex screw into cylinder
plate hole 1 with a hex screwdriver".  The vocabulary tables are dataset
facts (the HA-ViD annotation code book), not code.
"""

from __future__ import annotations

from typing import Dict, List, Optional

VERB_MAP = {
    "a": "approaches",
    "d": "disassembles",
    "g": "grasps",
    "h": "holds",
    "i": "inserts",
    "l": "slides",
    "m": "moves",
    "p": "places",
    "r": "rotates",
    "s": "screws",
}

VERB_PREP = {
    "approaches": "to",
    "disassembles": "from",
    "grasps": "",
    "holds": "",
    "inserts": "into",
    "slides": "onto",
    "moves": "to",
    "places": "onto",
    "rotates": "on",
    "screws": "into",
}

OBJECTS_MAP = {
    "ba": "ball",
    "bs": "ball seat",
    "bx": "box",
    "c1": "cylinder plate hole 1",
    "c2": "cylinder plate hole 2",
    "c3": "cylinder plate hole 3",
    "c4": "cylinder plate hole 4",
    "cb": "cylinder base",
    "cc": "cylinder cap",
    "ck": "cylinder bracket",
    "cs": "cylinder subassembly",
    "dh": "hex screwdriver",
    "dp": "philips screwdriver",
    "ft": "gear shaft",
    "g1": "gear plate hole 1",
    "g2": "gear plate hole 2",
    "g3": "gear plate hole 3",
    "gl": "large gear",
    "gs": "small gear",
    "gw": "worm gear",
    "hd": "dial",
    "hq": "quarter-turn handle",
    "hw": "hand-wheel",
    "ib": "bar",
    "n6": "general plate usb female",
    "nt": "nut",
    "pl": "large spacer",
    "ps": "small spacer",
    "sb": "bolt",
    "ir": "rod",
    "lb": "linear bearing",
    "n1": "general plate hole 1",
    "n2": "general plate hole 2",
    "n3": "general plate hole 3",
    "n4": "general plate hole 4",
    "n5": "general plate stud",
    "sh": "hex screw",
    "sp": "philips screw",
    "us": "usb male",
    "wn": "nut wrench",
    "ws": "shaft wrench",
}

TOOL_MAP = {
    "dh": "hex screwdriver",
    "dp": "philips screwdriver",
    "wn": "nut wrench",
    "ws": "shaft wrench",
}

NOISE_MAP = {"null": "null", "w": "wrong"}


def parse_havid_label(label: str) -> Dict[str, Optional[str]]:
    """Split a HA-ViD code into verb / manipulated / target / tool words."""
    empty = {"verb": None, "manipulated_object": None, "target_object": None, "tool": None}
    if not label:
        return dict(empty)

    lab = label.strip().lower()
    if lab in NOISE_MAP:
        return {**empty, "verb": NOISE_MAP[lab]}

    parsed = dict(empty)
    verb = VERB_MAP.get(lab[0], lab[0])
    parsed["verb"] = verb
    if len(lab) >= 3:
        parsed["manipulated_object"] = OBJECTS_MAP.get(lab[1:3], lab[1:3])
    if len(lab) >= 5:
        parsed["target_object"] = OBJECTS_MAP.get(lab[3:5], lab[3:5])
    if len(lab) >= 7:
        parsed["tool"] = TOOL_MAP.get(lab[5:7], lab[5:7])
    return parsed


def generate_action_prompt(label: str, template: Optional[str] = None) -> str:
    """HA-ViD code -> natural-language sentence."""
    parsed = parse_havid_label(label)
    verb = parsed["verb"]
    manipulated = parsed["manipulated_object"]
    target = parsed["target_object"]
    tool = parsed["tool"]

    if verb in ("null", "wrong"):
        return f"noise: {verb}"

    prep = VERB_PREP.get(verb, "") if verb else ""

    if template is None:
        if tool and target and manipulated:
            if prep:
                template = "a person {verb} a {manipulated_object} {prep} {target_object} with a {tool}"
            else:
                template = "a person {verb} a {manipulated_object} to {target_object} with a {tool}"
        elif target and manipulated:
            if prep:
                template = "a person {verb} a {manipulated_object} {prep} {target_object}"
            else:
                template = "a person {verb} a {manipulated_object} to {target_object}"
        elif manipulated:
            template = "a person {verb} a {manipulated_object}"
        else:
            template = "a person {verb}"

    prompt = template.format(
        verb=verb if verb else "perform action",
        manipulated_object=manipulated if manipulated else "object",
        target_object=target if target else "target",
        tool=tool if tool else "tool",
        prep=prep.strip(),
    )
    return prompt.replace("  ", " ").replace(" a a ", " a ").strip()


def get_all_prompts(label2index: Dict[str, int], index2label: Dict[int, str],
                    template: Optional[str] = None) -> List[str]:
    """Prompts ordered by class index."""
    prompts = []
    for i in range(len(index2label)):
        lbl = index2label.get(i)
        if lbl is None:
            prompts.append(f"a person performs action {i}")
        else:
            prompts.append(generate_action_prompt(lbl, template))
    return prompts


def is_havid_label(label: str) -> bool:
    if not label:
        return False
    lab = label.strip().lower()
    return lab in NOISE_MAP or lab[0] in VERB_MAP


def generate_simple_prompt(label: str, template: str = "a person {action}") -> str:
    return template.format(action=label.replace("_", " "))
