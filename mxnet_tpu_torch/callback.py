"""Training callbacks (ref: python/mxnet/callback.py;
``mxnet_tpu/callback.py`` of the JAX package)."""
from __future__ import annotations

import logging
import sys
import time


class Speedometer:
    """Log samples/sec + metric every N batches (ref: mx.callback.Speedometer)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0
        self.last_count = 0

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                speed = self.frequent * self.batch_size / \
                    (time.time() - self.tic)
                if param.eval_metric is not None:
                    nv = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = "\t".join(f"{n}={v:.6f}" for n, v in nv)
                    logging.info(
                        "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\t%s",
                        param.epoch, count, speed, msg)
                else:
                    logging.info(
                        "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                        param.epoch, count, speed)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


class LogValidationMetricsCallback:
    def __call__(self, param):
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name,
                         value)


def do_checkpoint(prefix, period=1):
    """Epoch-end checkpoint callback (ref: mx.callback.do_checkpoint).

    `prefix` is either the legacy path prefix (compat shim: writes
    ``prefix-symbol.json`` + ``prefix-NNNN.params`` exactly like the
    reference, now atomically) or a ``checkpoint.CheckpointManager`` —
    then every period-th epoch commits through the manager's atomic
    step-tagged layout (symbol JSON in the manifest's ``extra``) with
    retention and ``latest()``/``restore()`` resume.
    """
    from .checkpoint import CheckpointManager

    if isinstance(prefix, CheckpointManager):
        manager = prefix

        def _manager_callback(iter_no, sym, arg, aux):
            if (iter_no + 1) % period == 0:
                payload = {f"arg:{k}": v for k, v in arg.items()}
                payload.update({f"aux:{k}": v for k, v in aux.items()})
                # sync: epoch-end cadence (legacy semantics), and the
                # last epoch's callback may be the process's final act —
                # an async failure there would never surface
                manager.save(
                    iter_no + 1, params=payload, epoch=iter_no + 1,
                    extra={"symbol": sym.tojson()} if sym is not None
                    else None, sync=True)

        return _manager_callback

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            from .module.module import save_checkpoint

            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)

    return _callback


def log_train_metric(period, auto_reset=False):
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()

    return _callback


class BatchEndParam:
    def __init__(self, epoch, nbatch, eval_metric, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


class ProgressBar:
    """Text progress bar per batch (ref: mx.callback.ProgressBar —
    `nbatch` is the 0-based batch index Module.fit emits)."""

    def __init__(self, total, length=80):
        self.total = max(int(total), 1)
        self.length = int(length)

    def __call__(self, param):
        count = (param.nbatch % self.total) + 1
        filled = int(self.length * count / self.total)
        bar = "#" * filled + "-" * (self.length - filled)
        sys.stdout.write(f"\r[{bar}] {count}/{self.total}")
        if count == self.total:
            sys.stdout.write("\n")
        sys.stdout.flush()
