"""add: the named objects' masks at their frame.

    {"at": 20, "kind": "add", "objects": [2]}

The step of the frame gets the seeded video's index mask with only those
objects in it, InferenceCore.step(image, mask, objects), as eval_vos does
under use_all_masks when a video's object first appears: the program
propagates the objects it has, merges the mask with that prediction, and
memorizes the frame, the new objects' tokens as permanent memory of a
bucket of their own. At position 0 it is a video's first frame.
"""


def program(core, event, frame):
    frame.give(frame.objects_mask(event["objects"]), event["objects"])


def reference(stream, event, frame):
    frame.give(frame.objects_mask(event["objects"]), event["objects"])


def schedule(memory, event):
    memory.mask(event["objects"])
