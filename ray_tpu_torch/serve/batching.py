"""Dynamic request batching (reference: ray ``python/ray/serve/batching.py``
— ``@serve.batch`` collects concurrent calls into one batched invocation).

Usage inside a deployment class (the wrapped method receives a list of the
queued single-call arguments and must return a list of results):

    @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.01)
    async def infer(self, inputs):  # inputs: List[x]
        return model(np.stack(inputs)).tolist()
"""

from __future__ import annotations

import asyncio
import functools
from typing import Any, List


class _Batcher:
    def __init__(self, fn, max_batch_size: int, timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout_s = timeout_s
        self._queue: List = []  # (arg, future)
        self._flusher: asyncio.Task | None = None

    async def submit(self, owner, arg):
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._queue.append((arg, fut))
        if len(self._queue) >= self.max_batch_size:
            await self._flush(owner)
        elif self._flusher is None or self._flusher.done():
            self._flusher = loop.create_task(self._delayed_flush(owner))
        return await fut

    async def _delayed_flush(self, owner):
        await asyncio.sleep(self.timeout_s)
        await self._flush(owner)

    async def _flush(self, owner):
        if not self._queue:
            return
        batch, self._queue = self._queue, []
        args = [a for a, _ in batch]
        try:
            if owner is not None:
                results = await self.fn(owner, args)
            else:
                results = await self.fn(args)
            if len(results) != len(args):
                raise ValueError(
                    f"batched function returned {len(results)} results for "
                    f"{len(args)} inputs"
                )
            for (_, fut), res in zip(batch, results):
                if not fut.done():
                    fut.set_result(res)
        except Exception as e:  # noqa: BLE001
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)


def batch(_fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    def wrap(fn):
        batcher = _Batcher(fn, max_batch_size, batch_wait_timeout_s)

        @functools.wraps(fn)
        async def wrapper(*args):
            if len(args) == 2:  # bound method: (self, arg)
                owner, arg = args
            else:
                owner, arg = None, args[0]
            return await batcher.submit(owner, arg)

        wrapper._is_serve_batch = True
        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap
