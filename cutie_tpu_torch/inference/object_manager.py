"""Host-side object bookkeeping: immutable object ids <-> dense slot ids.

The port's copy of cutie_tpu/inference/object_manager.py (reference
cutie/inference/{object_info,object_manager}.py).
Temporary ids are 1-based tensor positions (0 is background); deleting objects
re-packs them. All pure Python — the device only ever sees the padded slot
axis plus a selector mask.
"""
from __future__ import annotations

from typing import Dict, List, Tuple, Union

import numpy as np


class ObjectInfo:
    """Object id + missed-detection counter (reference object_info.py:1-24)."""

    def __init__(self, id: int):
        self.id = id
        self.poke_count = 0

    def poke(self) -> None:
        self.poke_count += 1

    def unpoke(self) -> None:
        self.poke_count = 0

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        if isinstance(other, ObjectInfo):
            return self.id == other.id
        return self.id == other

    def __repr__(self):
        return f"(ID: {self.id})"


class ObjectManager:
    def __init__(self):
        self.obj_to_tmp_id: Dict[ObjectInfo, int] = {}
        self.tmp_id_to_obj: Dict[int, ObjectInfo] = {}
        self.obj_id_to_obj: Dict[int, ObjectInfo] = {}
        self.all_historical_object_ids: List[int] = []

    def _recompute_obj_id_to_obj_mapping(self) -> None:
        self.obj_id_to_obj = {obj.id: obj for obj in self.obj_to_tmp_id}

    def add_new_objects(
            self, objects: Union[List[Union[ObjectInfo, int]], ObjectInfo, int]
    ) -> Tuple[List[int], List[int]]:
        if not isinstance(objects, list):
            objects = [objects]

        corresponding_tmp_ids = []
        corresponding_obj_ids = []
        for obj in objects:
            if isinstance(obj, int):
                obj = ObjectInfo(id=obj)
            if obj in self.obj_to_tmp_id:
                corresponding_tmp_ids.append(self.obj_to_tmp_id[obj])
                corresponding_obj_ids.append(obj.id)
            else:
                new_obj = ObjectInfo(id=obj.id)
                new_tmp_id = len(self.obj_to_tmp_id) + 1
                self.obj_to_tmp_id[new_obj] = new_tmp_id
                self.tmp_id_to_obj[new_tmp_id] = new_obj
                self.all_historical_object_ids.append(new_obj.id)
                corresponding_tmp_ids.append(new_tmp_id)
                corresponding_obj_ids.append(new_obj.id)
        self._recompute_obj_id_to_obj_mapping()
        assert corresponding_tmp_ids == sorted(corresponding_tmp_ids)
        return corresponding_tmp_ids, corresponding_obj_ids

    def delete_objects(self, obj_ids_to_remove: Union[int, List[int]]) -> None:
        if isinstance(obj_ids_to_remove, int):
            obj_ids_to_remove = [obj_ids_to_remove]
        new_tmp_id = 1
        total = len(self.obj_to_tmp_id)
        new_obj_to_tmp, new_tmp_to_obj = {}, {}
        for tmp_iter in range(1, total + 1):
            obj = self.tmp_id_to_obj[tmp_iter]
            if obj.id not in obj_ids_to_remove:
                new_obj_to_tmp[obj] = new_tmp_id
                new_tmp_to_obj[new_tmp_id] = obj
                new_tmp_id += 1
        self.obj_to_tmp_id = new_obj_to_tmp
        self.tmp_id_to_obj = new_tmp_to_obj
        self._recompute_obj_id_to_obj_mapping()

    def purge_inactive_objects(
            self, max_missed_detection_count: int) -> Tuple[bool, List[int], List[int]]:
        obj_id_to_be_deleted, tmp_id_to_keep, obj_id_to_keep = [], [], []
        for obj in self.obj_to_tmp_id:
            if obj.poke_count > max_missed_detection_count:
                obj_id_to_be_deleted.append(obj.id)
            else:
                tmp_id_to_keep.append(self.obj_to_tmp_id[obj])
                obj_id_to_keep.append(obj.id)
        purge_activated = len(obj_id_to_be_deleted) > 0
        if purge_activated:
            self.delete_objects(obj_id_to_be_deleted)
        return purge_activated, tmp_id_to_keep, obj_id_to_keep

    def tmp_to_obj_cls(self, mask: np.ndarray) -> np.ndarray:
        new_mask = np.zeros_like(mask)
        for tmp_id, obj in self.tmp_id_to_obj.items():
            new_mask[mask == tmp_id] = obj.id
        return new_mask

    def get_tmp_to_obj_mapping(self) -> Dict[int, int]:
        return {obj.id: tmp_id for tmp_id, obj in self.tmp_id_to_obj.items()}

    def make_one_hot(self, cls_mask: np.ndarray) -> np.ndarray:
        out = [cls_mask == obj.id for _, obj in self.tmp_id_to_obj.items()]
        if not out:
            return np.zeros((0, *cls_mask.shape), bool)
        return np.stack(out, 0)

    @property
    def all_obj_ids(self) -> List[int]:
        return [k.id for k in self.obj_to_tmp_id]

    @property
    def num_obj(self) -> int:
        return len(self.obj_to_tmp_id)

    def has_all(self, objects: List[int]) -> bool:
        return all(obj in self.obj_to_tmp_id for obj in objects)

    def find_object_by_id(self, obj_id: int) -> ObjectInfo:
        return self.obj_id_to_obj[obj_id]

    def find_tmp_by_id(self, obj_id: int) -> int:
        return self.obj_to_tmp_id[self.obj_id_to_obj[obj_id]]
