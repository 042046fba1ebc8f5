"""delete: the named objects leave, before the step of their frame.

    {"at": 120, "kind": "delete", "objects": [1]}

InferenceCore.delete_objects(objects), as scripting_demo_add_del_objects
does: their values, sensory and object memory go, a bucket left without
objects goes with its tokens, and the other objects are renumbered in
order. The call's time counts in the frame.
"""


def program(core, event, frame):
    core.delete_objects(event["objects"])


def reference(stream, event, frame):
    stream.delete_objects(event["objects"])


def schedule(memory, event):
    memory.delete(event["objects"])
