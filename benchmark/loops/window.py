"""The train window as `train_mvr` runs it on the card: the whole dataset
on the device, `trainer.make_train_window`, k steps per dispatch (the
CLI's automatic k), each step a replay of one captured CUDA graph (on the
CPU the same step runs eagerly)."""
from benchmark.harness import Loop as Base


class Loop(Base):
    def _setup(self):
        from dss_tpu_torch.apps.train_mvr import steps_per_dispatch
        from dss_tpu_torch.training.trainer import make_train_window

        d = self.data
        self.k = steps_per_dispatch(-1, self.spe, self.print_every)
        self.window = make_train_window(
            self.settings, self.tcfg, self.schedule, self.state, self.cams,
            self.lights, d["img"], d["mask"], d["depth"],
            graph=self.device.type == "cuda")

    def _tensors(self):
        opt = self.state.optimizer
        adam = [opt.state[t][key] for t in self.state.params.tensors()
                for key in ("step", "exp_avg", "exp_avg_sq")]
        f = self.window.filters
        return [*self.state.params.tensors(), *adam, f.activation,
                f.visibility, f.inmask]

    def _dispatch(self, epoch):
        self.state, m = self.window(self.state, epoch, self.k)
        return m
