"""A loop for the tests, copied into a copy of the benchmark's `loops/`:
the port's eager multi-scene step as `apps.train_multiscene` takes it,
one step per dispatch: `trainer.make_stacked_loss_fn` over the scenes'
camera and light batches and (S, V, ...) images of the step's view slots,
`trainer._grads`, and the guarded update (`trainer.apply_update`:
`kernels.all_finite`, then `trainer.guarded_adam_`)."""
from benchmark.harness import Loop as Base


class Loop(Base):
    def _setup(self):
        from dss_tpu_torch.training import trainer

        self.k = 1
        self.loss_fn = trainer.make_stacked_loss_fn(
            self.settings, self.tcfg, self.schedule)

    def _tensors(self):
        opt = self.state.optimizer
        adam = [opt.state[t][key] for t in self.state.params.tensors()
                for key in ("step", "exp_avg", "exp_avg_sq")]
        f = self.state.filters
        return [*self.state.params.tensors(), *adam, f.activation,
                f.visibility, f.inmask]

    def _dispatch(self, epoch):
        from dss_tpu_torch.training import trainer

        st, d = self.state, self.data
        v = epoch[st.step % self.spe]
        take = lambda batches: [trainer.take_views(b, v) for b in batches]
        grads, total, parts, new_filters = trainer._grads(
            st.params, lambda: self.loss_fn(
                st.params, st.filters, take(self.cams), take(self.lights),
                d["img"][:, v], d["mask"][:, v], st.step,
                None if d["depth"] is None else d["depth"][:, v]))
        self.state, m = trainer.apply_update(st, grads, total, parts,
                                             new_filters)
        return m
