"""English realization of instantiated question templates.

Rebuild of QuestionBuild (scripts/question_build.py): set expansion, general
tag substitution with pluralization ('switch'->'switches', 'balcony'->
'balconies', 'shoes' unchanged), attribute insertion (colors before the noun,
room locations after, as 'located in the X' unless 'everywhere'), a/an
articles, whitespace cleanup, '_'->' ' and '|'->'/' rewrites.
"""

from __future__ import annotations

import re


def _pluralize(word):
    if word == "switch":
        return word + "es"
    if word == "balcony":
        return word[:-1] + "ies"
    if word == "shoes":
        return word
    return word + "s"


def _replace_general(text, items):
    """Substitute <obj_type*>, <room_type*>, <color> tags, pluralizing where
    the template uses the -pl form (scripts/question_build.py:12-30)."""
    for tag, value in items.items():
        pl_tag = tag[:-1] + "-pl>"
        if pl_tag in text:
            tag, value = pl_tag, _pluralize(value)
        text = text.replace(tag, value)
    return re.sub(" +", " ", text)


def _insert_room_location(text, tag, value):
    """Room locations go after the tagged noun (scripts/question_build.py:52-68)."""
    pos = text.find(tag)
    toks = text[pos:].split(" ")
    if len(toks) < 2:
        insert_pos = len(text) - 1
    else:
        insert_pos = pos + text[pos:].find(toks[1]) + len(toks[1])
    if text[insert_pos - 1] == "?":
        insert_pos -= 1
    if value != "everywhere":
        value = "located in the " + value
    return text[:insert_pos] + " " + value + text[insert_pos:]


def _replace_attrs(text, attr_info):
    for tag, inst in attr_info.items():
        for value, attr_type in zip(inst["value"], inst["type"]):
            if attr_type != "room_location":
                pos = text.find(tag)
                text = text[:pos] + value + text[pos:]
            else:
                text = _insert_room_location(text, tag, value)
        text = text.replace(tag, "")
        if text.endswith("are ?"):  # 'How many Xs are <attr>?' with empty attr
            text = text[:-1] + "there?"
    return re.sub(" +", " ", text)


def _replace_articles(text):
    pos = text.find("<art>")
    while pos != -1:
        assert pos + 6 < len(text), "Beyond end of question string!"
        article = "an" if text[pos + 6] in "aeiou" else "a"
        text = text.replace("<art>", article, 1)
        pos = text.find("<art>")
    return re.sub(" +", " ", text)


def _expand_set(text, set_size):
    """set(<tags{}>) -> '<tags1> and <tags2> [and <tags3>]'
    (scripts/question_build.py:98-112)."""
    inner = re.findall(r"set\((.*?)\)", text)[0]
    pos = text.find("set(")
    parts = [inner.replace("{}", str(i + 1)) for i in range(set_size)]
    expanded = " and ".join(parts)
    return re.sub(" +", " ", text[:pos] + expanded + text[pos + 5 + len(inner):])


def realize_question(template, tag_instantiations, *, set_size=None):
    text = template
    if "set(" in text:
        assert set_size is not None, "Did not receive a set size for the question!"
        text = _expand_set(text, set_size)

    attr_info, other = {}, {}
    for tag, inst in tag_instantiations.items():
        tagged = "<" + tag + ">"
        if tag in ("rel", "comp", "comp_rel", "comp_sup"):
            text = text.replace(tagged, inst["value"])
        elif "attr" in tag:
            assert len(inst["value"]) == len(inst["type"]), \
                "'value' and 'type' list sizes for attr tags don't match!"
            attr_info[tagged] = inst
        else:
            other[tagged] = inst["value"]

    text = _replace_general(text, other)
    text = _replace_attrs(text, attr_info)
    text = _replace_articles(text)
    return text.replace("_", " ").replace("|", "/")
