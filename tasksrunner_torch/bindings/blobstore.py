"""A blob store in a directory, as an output binding: the port of
``tasksrunner/bindings/blobstore.py``.

It stands in for ``bindings.azure.blobstorage``, where the reference's
processor archives each external task as ``{taskId}.json`` (metadata
``blobName``). Operations: ``create`` (a name made up when none is
given; bytes and strings as they are, anything else as indented JSON,
UTF-8), ``get``, ``delete``, ``list``. A name that resolves outside the
container is refused. File access runs off the loop; paths go through
``os.path``, not ``pathlib`` (on CPython 3.12 pathlib interns each path
component for good, and blob names are unique per task).
"""

from __future__ import annotations

import asyncio
import json
import os
import pathlib
import uuid
from typing import Any

from tasksrunner_torch.bindings.base import BindingResponse, OutputBinding
from tasksrunner_torch.component.registry import driver
from tasksrunner_torch.component.spec import ComponentSpec
from tasksrunner_torch.errors import BindingError


def _write_blob(path: str, payload: bytes) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(payload)


def _read_blob(path: str) -> bytes | None:
    if not os.path.isfile(path):
        return None
    with open(path, "rb") as f:
        return f.read()


class LocalBlobStoreBinding(OutputBinding):
    def __init__(self, name: str, root: str | pathlib.Path, *, container: str = "blobs") -> None:
        super().__init__(name)
        self.root = pathlib.Path(root) / container
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, blob_name: str) -> str:
        root = os.path.realpath(str(self.root))
        p = os.path.realpath(os.path.join(root, blob_name))
        if not (p == root or p.startswith(root + os.sep)):
            raise BindingError(f"blob name {blob_name!r} escapes the container")
        return p

    async def invoke(self, operation: str, data: Any,
                     metadata: dict[str, str] | None = None) -> BindingResponse:
        metadata = metadata or {}
        loop = asyncio.get_running_loop()
        if operation == "list":
            root = str(self.root)
            names = []
            for dirpath, _dirs, files in os.walk(root):
                rel = os.path.relpath(dirpath, root)
                names += [f if rel == "." else os.path.join(rel, f) for f in files]
            return BindingResponse(data=sorted(names))

        blob_name = metadata.get("blobName")
        if not blob_name:
            if operation != "create":
                raise BindingError(f"{operation} requires blobName metadata")
            blob_name = str(uuid.uuid4())
        path = self._path(blob_name)

        if operation == "create":
            if isinstance(data, (bytes, bytearray)):
                payload = bytes(data)
            elif isinstance(data, str):
                payload = data.encode("utf-8")
            else:
                payload = json.dumps(data, indent=2).encode("utf-8")
            await loop.run_in_executor(None, _write_blob, path, payload)
            return BindingResponse(metadata={"blobName": blob_name})
        if operation == "get":
            blob = await loop.run_in_executor(None, _read_blob, path)
            if blob is None:
                raise BindingError(f"blob {blob_name!r} does not exist")
            return BindingResponse(data=blob, metadata={"blobName": blob_name})
        if operation == "delete":
            existed = os.path.isfile(path)
            if existed:
                os.unlink(path)
            return BindingResponse(metadata={"deleted": "true" if existed else "false"})
        raise BindingError(f"blob binding has no operation {operation!r}")


@driver("bindings.localblob", "bindings.azure.blobstorage")
def _blob_binding(spec: ComponentSpec, metadata: dict[str, str]) -> LocalBlobStoreBinding:
    """``blobPath`` (``.tasksrunner/blobs``) and ``container`` (``blobs``)."""
    return LocalBlobStoreBinding(spec.name, metadata.get("blobPath", ".tasksrunner/blobs"),
                                 container=metadata.get("container", "blobs"))
